"""SHA-256-CTR deterministic streams and k-unique index selection.

Reference: the local ``Ctr`` rngs inside prg_choose_k / gen_ubk_public
(include/pvac/crypto/matrix.hpp:15-164).  A stream is defined by a label and
a list of u64 words; refill c yields the 32-byte digest
SHA-256(label || le64(words...) || le64(c)), read as 4 little-endian u64s.
``bounded(M)`` rejection-samples x <= 2^64-1 - ((2^64-1) % M) and returns
x % M; ``choose_k`` draws until k unique indices are collected.

Two implementations with identical outputs:

- scalar (hashlib) — exact mirror of the reference control flow; used for
  fallbacks and small host-side jobs;
- vectorized — many independent streams at once as uint32 lane arrays
  (numpy or jax.numpy), generating a static overshoot of draws and selecting
  the first k unique ones with order-preserving dedup.  Bounded-rejection
  (probability M/2^64 per draw) sets a per-lane fallback flag instead of
  looping; callers re-run flagged lanes through the scalar path.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

from ..core import hash as H

U32 = np.uint32
U64MAX = (1 << 64) - 1


# ---------------------------------------------------------------------------
# scalar path (reference mirror)
# ---------------------------------------------------------------------------

class CtrStream:
    """Sequential u64 stream (matrix.hpp:21-76)."""

    def __init__(self, label: str | bytes, words):
        self.prefix = label.encode() if isinstance(label, str) else label
        self.words = [w & U64MAX for w in words]
        self.ctr = 0
        self.buf = b""
        self.idx = 32

    def _refill(self) -> None:
        h = hashlib.sha256()
        h.update(self.prefix)
        for w in self.words:
            h.update(struct.pack("<Q", w))
        h.update(struct.pack("<Q", self.ctr))
        self.ctr += 1
        self.buf = h.digest()
        self.idx = 0

    def rnd(self) -> int:
        if self.idx >= 32:
            self._refill()
        x = struct.unpack_from("<Q", self.buf, self.idx)[0]
        self.idx += 8
        return x

    def bounded(self, M: int) -> int:
        if M <= 1:
            return 0
        lim = U64MAX - (U64MAX % M)
        while True:
            x = self.rnd()
            if x <= lim:
                return x % M


def choose_k_scalar(k: int, N: int, label: str | bytes, words) -> list[int]:
    """prg_choose_k (matrix.hpp:15-92): first k unique bounded draws."""
    rng = CtrStream(label, words)
    used = set()
    out = []
    while len(out) < k:
        x = rng.bounded(N)
        if x not in used:
            used.add(x)
            out.append(x)
    return out


# ---------------------------------------------------------------------------
# vectorized path
# ---------------------------------------------------------------------------

def _layout(label: bytes, n_words: int) -> H.MsgLayout:
    return H.MsgLayout(label, n_words + 1)  # +1 for the counter field


def stream_u64s(label: str | bytes, words_lanes, n_u64: int):
    """Vectorized stream: words_lanes [L, n_words, 2] uint32 (lo, hi) per
    lane -> [L, n_u64, 2] uint32 little-endian u64 halves, in stream order.

    Works under numpy and jax.numpy (jit-safe, static shapes).
    """
    xp = np if type(words_lanes).__module__.startswith("numpy") else __import__(
        "jax.numpy", fromlist=["x"]
    )
    prefix = label.encode() if isinstance(label, str) else label
    L_batch = words_lanes.shape[0]
    n_words = words_lanes.shape[1]
    n_refills = (n_u64 + 3) // 4
    layout = _layout(prefix, n_words)

    # fields per (lane, refill): words + counter
    ctr = xp.arange(n_refills, dtype=U32)
    zeros = xp.zeros((n_refills,), dtype=U32)
    ctr_fields = xp.stack([ctr, zeros], axis=-1)  # [R, 2]
    w = xp.broadcast_to(
        words_lanes[:, None, :, :], (L_batch, n_refills, n_words, 2)
    )
    c = xp.broadcast_to(
        ctr_fields[None, :, None, :], (L_batch, n_refills, 1, 2)
    )
    fields = xp.concatenate([w, c], axis=2)  # [L, R, n_words+1, 2]

    blocks = layout.build_blocks(fields)  # [L, R, nb, 16]
    state = H.sha256_init_state((L_batch, n_refills), xp)
    for b in range(layout.n_blocks):
        state = H.sha256_compress(state, blocks[:, :, b, :])
    u64s = H.digest_words_to_le_u64_pairs(state)  # [L, R, 4, 2]
    u64s = u64s.reshape(L_batch, n_refills * 4, 2)
    return u64s[:, :n_u64, :]


def mod_u64(u64_pairs, M: int):
    """x mod M for u64s given as (lo32, hi32) pairs; M < 2^16 so all
    intermediates fit in uint32."""
    assert 1 <= M < (1 << 16)
    lo = u64_pairs[..., 0]
    hi = u64_pairs[..., 1]
    m = U32(M)
    t32 = U32((1 << 32) % M)
    return ((hi % m) * t32 + lo % m) % m


def bounded_ok_mask(u64_pairs, M: int):
    """True where x <= lim = 2^64-1 - ((2^64-1) % M) (acceptance mask)."""
    lim = U64MAX - (U64MAX % M)
    lim_lo = U32(lim & 0xFFFFFFFF)
    lim_hi = U32(lim >> 32)
    lo = u64_pairs[..., 0]
    hi = u64_pairs[..., 1]
    return (hi < lim_hi) | ((hi == lim_hi) & (lo <= lim_lo))


def draws_and_take(k: int, N: int, label: str | bytes, words_lanes,
                   overshoot: int = 16):
    """Vectorized prg_choose_k without the order-compaction step.

    Returns (vals [L, D] int32, take [L, D] bool, fallback [L] bool) where
    ``take`` marks the first k first-occurrence draws.  Because every
    consumer of the selected indices is order-insensitive (XOR of H columns,
    XOR of single bits), the selected set {vals[take]} is all that's needed —
    skipping the rank->slot scatter of :func:`choose_k_batch`, which is the
    costliest stage of the σ program.

    Semantics match the reference prg_choose_k (matrix.hpp:15-92) as a set;
    lanes where the D-draw window can't produce k uniques (or a bounded
    rejection occurs) are flagged for the scalar fallback.
    """
    xp = np if type(words_lanes).__module__.startswith("numpy") else __import__(
        "jax.numpy", fromlist=["x"]
    )
    D = k + overshoot
    u64s = stream_u64s(label, words_lanes, D)
    ok = bounded_ok_mask(u64s, N)
    vals = mod_u64(u64s, N).astype(np.int32)
    if xp is np:
        pos = xp.broadcast_to(xp.arange(D, dtype=np.int32)[None, :], vals.shape)
        packed = vals * np.int32(D) + pos
        order = xp.argsort(packed, axis=-1)
        sv = xp.take_along_axis(vals, order, axis=-1)
        first_sorted = xp.concatenate(
            [xp.ones_like(sv[:, :1], dtype=bool), sv[:, 1:] != sv[:, :-1]],
            axis=-1,
        )
        first = xp.zeros_like(first_sorted)
        rows = np.arange(vals.shape[0])[:, None]
        first[rows, order] = first_sorted
    else:
        earlier = xp.tril(xp.ones((D, D), dtype=bool), k=-1)
        dup = ((vals[:, :, None] == vals[:, None, :]) & earlier[None]).any(-1)
        first = ~dup
    rank = xp.cumsum(first.astype(np.int32), axis=-1)
    take = first & (rank <= k)
    fallback = (rank[:, -1] < k) | (~ok).any(axis=-1)
    return vals, take, fallback


def choose_k_batch(k: int, N: int, label: str | bytes, words_lanes,
                   overshoot: int = 64):
    """Vectorized prg_choose_k over many lanes.

    words_lanes: [L, n_words, 2] uint32.  Returns (indices [L, k] int32,
    fallback [L] bool).  ``fallback`` lanes (bounded-rejection hit, or more
    duplicates than the overshoot allows — both vanishingly rare) must be
    recomputed with :func:`choose_k_scalar`.
    """
    xp = np if type(words_lanes).__module__.startswith("numpy") else __import__(
        "jax.numpy", fromlist=["x"]
    )
    D = k + overshoot
    u64s = stream_u64s(label, words_lanes, D)  # [L, D, 2]
    ok = bounded_ok_mask(u64s, N)  # [L, D]
    vals = mod_u64(u64s, N).astype(np.int32)  # [L, D]

    if xp is np:
        # Order-preserving first-occurrence dedup via sort:
        # pack (value, position); after an ascending sort equal values are
        # adjacent with ascending position, so the first element of each run
        # is the first occurrence.  Scatter that flag back to stream
        # positions.
        pos = xp.broadcast_to(
            xp.arange(D, dtype=np.int32)[None, :], vals.shape
        )
        packed = vals * np.int32(D) + pos  # N*D < 2^31 for all scheme sizes
        order = xp.argsort(packed, axis=-1)
        sv = xp.take_along_axis(vals, order, axis=-1)
        first_sorted = xp.concatenate(
            [xp.ones_like(sv[:, :1], dtype=bool), sv[:, 1:] != sv[:, :-1]],
            axis=-1,
        )
        first = xp.zeros_like(first_sorted)
        rows = np.arange(vals.shape[0])[:, None]
        first[rows, order] = first_sorted
    else:
        # O(D^2) pairwise compare instead of a sort: draw j is a first
        # occurrence iff no earlier draw k<j equals it.
        earlier = xp.tril(xp.ones((D, D), dtype=bool), k=-1)  # [j, k]: k < j
        dup = ((vals[:, :, None] == vals[:, None, :]) & earlier[None]).any(-1)
        first = ~dup

    selected = first  # all draws assumed accepted; rejection -> fallback
    rank = xp.cumsum(selected.astype(np.int32), axis=-1)  # 1-based
    take = selected & (rank <= k)

    # Gather the first k selected values in stream order.
    out = xp.zeros((vals.shape[0], k), dtype=np.int32)
    dst = xp.where(take, rank - 1, k)  # parked writes go to a scratch slot
    if xp is np:
        out = np.zeros((vals.shape[0], k + 1), dtype=np.int32)
        rows = np.arange(vals.shape[0])[:, None]
        out[rows, dst] = vals
        out = out[:, :k]
    else:
        out = xp.zeros((vals.shape[0], k + 1), dtype=np.int32)
        out = out.at[xp.arange(vals.shape[0])[:, None], dst].set(
            xp.where(take, vals, 0)
        )
        out = out[:, :k]

    n_unique = rank[:, -1]
    fallback = (n_unique < k) | (~ok).any(axis=-1)
    return out, fallback
