"""LPN-based PRF R (reference: include/pvac/crypto/lpn.hpp:157-275).

prf_R(pk, sk, seed) = prod of three domain-separated cores; each core:
  1. derive_aes_key = SHA-256(prf_k || canon_tag || H_digest || seed || dom)
     (lpn.hpp:166-192), nonce = fnv1a(dom) ^ seed.nonce.lo
  2. t LPN samples y_r = <a_r, s> xor Ber(tau), a_r = 64 AES-CTR u64s per
     row, noise draw = bounded(8) < 1 (lpn.hpp:194-233)
  3. GF(2) Toeplitz compression to 127 bits with an AES-CTR top row from a
     TOEP-domain key (lpn.hpp:235-261)
  4. map to a nonzero field element (lpn.hpp:25-37)

Because convolution bit k depends only on operand bits 0..k, only LPN rows
0..126 (and the first toep block) influence the output — proven bit-exact
against the reference (tools/refharness/check_toep.cpp).  The batched path
computes exactly those rows: ~129x less AES than the reference per core.

Bounded-rejection in the noise draw (probability 8/2^64 per row) would shift
the stream; the batch path detects it and falls back to the exact scalar
mirror for affected lanes.
"""
from __future__ import annotations

import struct

import numpy as np

from ..core import field as F
from ..core import fieldv as FV
from ..core import hash as H
from ..types import Dom, PubKey, RSeed, SecKey
from . import aes as AES
from . import aesv
from . import toeplitz as TOEP

U32 = np.uint32
U64MAX = (1 << 64) - 1


def fnv1a_domain(dom: str | bytes) -> int:
    """FNV-1a of a domain string (lpn.hpp:157-164)."""
    if isinstance(dom, str):
        dom = dom.encode()
    h = 0xCBF29CE484222325
    for b in dom:
        h ^= b
        h = (h * 0x100000001B3) & U64MAX
    return h


DOM_HASH = {
    d: fnv1a_domain(d)
    for d in (
        Dom.H_GEN, Dom.X_SEED, Dom.NOISE, Dom.PRF_LPN, Dom.TOEP, Dom.ZTAG,
        Dom.COMMIT, Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3,
        Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3,
    )
}


def hash_to_fp_nonzero(lo: int, hi: int) -> int:
    """(lo, hi) -> nonzero field element (lpn.hpp:25-37)."""
    r = F.fp_from_words(lo, hi & F.MASK63)
    return r if r else 1


def _key_prefix(pk: PubKey, sk: SecKey) -> bytes:
    parts = [struct.pack("<Q", k & U64MAX) for k in sk.prf_k]
    parts.append(struct.pack("<Q", pk.canon_tag & U64MAX))
    parts.append(pk.H_digest)
    return b"".join(parts)


def derive_aes_key(pk: PubKey, sk: SecKey, seed: RSeed, dom: str) -> tuple[bytes, int]:
    """Scalar derive_aes_key (lpn.hpp:166-192)."""
    dom_hash = DOM_HASH.get(dom) or fnv1a_domain(dom)
    msg = _key_prefix(pk, sk) + struct.pack(
        "<QQQQ", seed.ztag & U64MAX, seed.nonce.lo & U64MAX,
        seed.nonce.hi & U64MAX, dom_hash,
    )
    return H.sha256(msg), dom_hash ^ (seed.nonce.lo & U64MAX)


def lpn_make_ybits(pk: PubKey, sk: SecKey, seed: RSeed, dom: str,
                   n_rows: int | None = None) -> list[int]:
    """Scalar mirror of lpn_make_ybits (lpn.hpp:194-233); optionally only the
    first n_rows rows (the stream position of row r is row-independent except
    for ~2^-61 bounded-rejections, which this exact mirror does handle)."""
    t = pk.prm.lpn_t if n_rows is None else min(n_rows, pk.prm.lpn_t)
    s_words = pk.prm.s_words64
    key, nonce = derive_aes_key(pk, sk, seed, dom)
    prg = AES.AesCtr256(key, nonce)
    ybits = [0] * ((pk.prm.lpn_t + 63) // 64)
    num, den = pk.prm.lpn_tau_num, pk.prm.lpn_tau_den
    for r in range(t):
        row = prg.fill_u64(s_words)
        acc = 0
        for wi in range(s_words):
            acc ^= row[wi] & sk.lpn_s_bits[wi]
        dot = bin(acc).count("1") & 1
        e = 1 if prg.bounded(den) < num else 0
        ybits[r >> 6] ^= (dot ^ e) << (r & 63)
    return ybits


def _toep_key_nonce(pk: PubKey, sk: SecKey, seed: RSeed, dom: str) -> tuple[bytes, int]:
    key, nonce = derive_aes_key(pk, sk, seed, Dom.TOEP)
    return key, nonce ^ (DOM_HASH.get(dom) or fnv1a_domain(dom))


def prf_R_core(pk: PubKey, sk: SecKey, seed: RSeed, dom: str) -> int:
    """Scalar core — single-lane call into the batched engine."""
    r = prf_cores_batch(
        pk, sk,
        np.array([[seed.ztag, seed.nonce.lo, seed.nonce.hi]], dtype=np.uint64),
        np.array([DOM_HASH.get(dom) or fnv1a_domain(dom)], dtype=np.uint64),
    )
    return FV.to_ints(r)[0]


def prf_R(pk: PubKey, sk: SecKey, seed: RSeed) -> int:
    r1 = prf_R_core(pk, sk, seed, Dom.PRF_R1)
    r2 = prf_R_core(pk, sk, seed, Dom.PRF_R2)
    r3 = prf_R_core(pk, sk, seed, Dom.PRF_R3)
    return F.fp_mul(F.fp_mul(r1, r2), r3)


def prf_R_noise(pk: PubKey, sk: SecKey, seed: RSeed) -> int:
    r1 = prf_R_core(pk, sk, seed, Dom.PRF_NOISE1)
    r2 = prf_R_core(pk, sk, seed, Dom.PRF_NOISE2)
    r3 = prf_R_core(pk, sk, seed, Dom.PRF_NOISE3)
    return F.fp_mul(F.fp_mul(r1, r2), r3)


# ---------------------------------------------------------------------------
# batched engine
# ---------------------------------------------------------------------------

def _rows_per_core(prm) -> int:
    # only LPN rows 0..126 influence the 127 toep output bits
    return min(127, prm.lpn_t)


def n_ybits_blocks(prm) -> int:
    """AES blocks needed for the influential rows of one core."""
    rows = _rows_per_core(prm)
    u64s = rows * (prm.s_words64 + 1)
    return (u64s + 1) // 2


def derive_keys_batch(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                      dom_hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized derive_aes_key.  seeds_u64 [N, 3] uint64 (ztag, lo, hi),
    dom_hashes [N] uint64 -> (keys [N, 32] uint8, nonces [N] uint64).

    Uses the threaded native SHA (SHA-NI) when available — this hash runs
    once per PRF core on the hot encryption path; the numpy lane-SHA
    below is the fallback/oracle."""
    prefix = _key_prefix(pk, sk)
    N = seeds_u64.shape[0]
    f64 = np.concatenate([seeds_u64, dom_hashes[:, None]], axis=1)
    nonces = (dom_hashes ^ seeds_u64[:, 1]).astype(np.uint64)

    from .. import native

    keys_nat = native.sha256_fields(prefix, f64)
    if keys_nat is not None:
        return keys_nat, nonces

    layout = H.MsgLayout(prefix, 4)
    fields = np.stack(
        [(f64 & np.uint64(0xFFFFFFFF)).astype(U32),
         (f64 >> np.uint64(32)).astype(U32)],
        axis=-1,
    )
    blocks = layout.build_blocks(fields)
    state = H.sha256_init_state((N,), np)
    for b in range(layout.n_blocks):
        state = H.sha256_compress(state, blocks[:, b, :])
    # digest bytes = BE(h0)..BE(h7)
    keys = np.zeros((N, 32), dtype=np.uint8)
    for i in range(8):
        keys[:, 4 * i + 0] = (state[:, i] >> 24) & 0xFF
        keys[:, 4 * i + 1] = (state[:, i] >> 16) & 0xFF
        keys[:, 4 * i + 2] = (state[:, i] >> 8) & 0xFF
        keys[:, 4 * i + 3] = state[:, i] & 0xFF
    nonces = dom_hashes ^ seeds_u64[:, 1]
    return keys, nonces


def _xp_of(a):
    if type(a).__module__.startswith("numpy"):
        return np
    import jax.numpy as jnp

    return jnp


def _xor_reduce_last(x):
    """XOR-fold over the last axis (size padded to a power of two)."""
    xp = _xp_of(x)
    n = x.shape[-1]
    p2 = 1
    while p2 < n:
        p2 *= 2
    if p2 != n:
        pad = xp.zeros((*x.shape[:-1], p2 - n), dtype=x.dtype)
        x = xp.concatenate([x, pad], axis=-1)
    while x.shape[-1] > 1:
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


def _parity_fold(x):
    """Per-element parity of a uint32 array (branch-free fold)."""
    x = x ^ (x >> U32(16))
    x = x ^ (x >> U32(8))
    x = x ^ (x >> U32(4))
    x = x ^ (x >> U32(2))
    x = x ^ (x >> U32(1))
    return x & U32(1)


def cores_from_streams(u64s, top_u, s32_flat, prm):
    """Shared core math: AES keystreams -> prf_R_core field elements.

    u64s: [N, 2*nblocks, 2] uint32 ybits keystream (lo, hi) halves;
    top_u: [N, 2, 2] first toep block; s32_flat: [2*s_words64] uint32 LPN
    secret.  Backend-agnostic (numpy / jnp under jit).  Returns
    (r_limbs [N, 4], rej [N, rows] bool).
    """
    xp = _xp_of(u64s)
    N = u64s.shape[0]
    rows = _rows_per_core(prm)
    sw64 = prm.s_words64

    # LPN rows: row r = u64 stream [r*(sw64+1), ...+sw64), noise at +sw64
    stride = sw64 + 1
    row_idx = (np.arange(rows)[:, None] * stride + np.arange(sw64)[None, :])
    rows_u = u64s[:, row_idx, :]  # [N, rows, sw64, 2]
    s32 = s32_flat.reshape(sw64, 2)
    acc = rows_u & s32[None, None, :, :]
    x = _xor_reduce_last(acc.reshape(N, rows, 2 * sw64))
    dot = _parity_fold(x)  # [N, rows]

    return _cores_tail(xp, dot, u64s, top_u, prm, rows, sw64)


def cores_from_streams_tp(u64s, top_u, s32_local, prm, axis_name="tp"):
    """Tensor-parallel cores_from_streams for use inside a shard_map body.

    The LPN secret contraction — the hottest HBM read of the whole scheme
    (SURVEY.md §6) — splits over the mesh axis ``axis_name``: each rank
    holds ``s_words64 / tp`` secret words (s32_local [2*loc_w] uint32) and
    ANDs only its word slice of every sample row; per-rank partial
    parities combine with one tiny ``psum`` ([N, rows] int32 — the only
    cross-rank traffic).  Noise bits, Toeplitz and the field map are
    rank-replicated (they read ~1/65th of the stream).  Bit-exact with
    :func:`cores_from_streams` (proven pattern: parallel/sharding.py).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    N = u64s.shape[0]
    rows = _rows_per_core(prm)
    sw64 = prm.s_words64
    loc_w = s32_local.shape[0] // 2
    tp_size = jax.lax.axis_size(axis_name)
    assert loc_w * tp_size == sw64, (
        f"LPN-tp slice misalignment: {tp_size} ranks x {loc_w} local u64 "
        f"words != s_words64={sw64} (callers must shard whole u64 pairs)"
    )
    t_idx = lax.axis_index(axis_name)
    stride = sw64 + 1
    base_idx = (np.arange(rows)[:, None] * stride
                + np.arange(loc_w)[None, :])  # [rows, loc_w]
    idx = jnp.asarray(base_idx) + t_idx * loc_w
    rows_u = jnp.take(u64s, idx.reshape(-1), axis=1).reshape(
        N, rows, loc_w, 2)
    s_loc = s32_local.reshape(loc_w, 2)
    acc = rows_u & s_loc[None, None, :, :]
    x = _xor_reduce_last(acc.reshape(N, rows, 2 * loc_w))
    partial = _parity_fold(x).astype(jnp.int32)
    dot = (lax.psum(partial, axis_name) % 2).astype(U32)  # [N, rows]
    return _cores_tail(jnp, dot, u64s, top_u, prm, rows, sw64)


def _noise_from_u64(xp, nz_lo, nz_hi, prm):
    """Bernoulli noise bit + bounded-rejection flag from the per-row noise
    u64 (lo, hi) halves."""
    den = prm.lpn_tau_den
    num = prm.lpn_tau_num
    # bounded(den) < num with strict-< acceptance; den is a power of two in
    # all configurations, so x % den = low bits.
    assert den & (den - 1) == 0, "lpn_tau_den must be a power of two"
    e = ((nz_lo & U32(den - 1)) < U32(num)).astype(U32)
    # rejection: x >= 2^64 - den  (lim = 2^64 - den; accept strictly below)
    rej = (nz_hi == U32(0xFFFFFFFF)) & (nz_lo >= U32((1 << 32) - den))
    return e, rej


def _cores_tail(xp, dot, u64s, top_u, prm, rows, sw64):
    """Noise sampling, y-bit packing, Toeplitz and field map shared by the
    replicated and tensor-parallel core paths."""
    stride = sw64 + 1
    noise_idx = np.arange(rows) * stride + sw64
    nz = u64s[:, noise_idx, :]  # [N, rows, 2]
    e, rej = _noise_from_u64(xp, nz[..., 0], nz[..., 1], prm)
    return _cores_tail2(xp, dot, e, rej, top_u, prm, rows)


def _cores_tail2(xp, dot, e, rej, top_u, prm, rows):
    """y-bit packing, Toeplitz compression and field map; dot/e [N, rows]."""
    N = dot.shape[0]
    y = dot ^ e  # [N, rows]
    # pack 127 bits -> [N, 4] uint32 (shifted bits are disjoint: XOR-fold)
    cols = []
    for k in range(4):
        lo, hi_ = 32 * k, min(32 * (k + 1), rows)
        if lo >= rows:
            cols.append(xp.zeros((N,), dtype=U32))
            continue
        chunk = y[:, lo:hi_]
        sh = xp.arange(hi_ - lo, dtype=U32)
        cols.append(_xor_reduce_last(chunk << sh))
    y4 = xp.stack(cols, axis=-1)

    top4 = xp.stack(
        [top_u[:, 0, 0], top_u[:, 0, 1], top_u[:, 1, 0], top_u[:, 1, 1]],
        axis=-1,
    )

    out127 = TOEP.conv127(y4, top4)  # [N, 4], bits 0..126
    r = FV.canon(out127)
    one = xp.broadcast_to(xp.asarray([1, 0, 0, 0], dtype=U32), r.shape)
    r = FV.select(FV.is_zero(r), one, r)
    return r, rej


def prf_cores_batch_start(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                          dom_hashes: np.ndarray):
    """N independent prf_R_core evaluations, split into dispatch + finalize
    so callers can overlap host work with the device computation.

    seeds_u64: [N, 3] uint64 (ztag, nonce_lo, nonce_hi); dom_hashes [N].
    Returns a zero-arg finalize() -> [N, 4] uint32 field limbs (numpy)."""
    prm = pk.prm
    N = seeds_u64.shape[0]
    nblocks = n_ybits_blocks(prm)

    engine = getattr(pk, "_engine", None)
    keys, nonces = derive_keys_batch(pk, sk, seeds_u64, dom_hashes)
    toep_keys, toep_base = derive_keys_batch(
        pk, sk, seeds_u64,
        np.full(N, DOM_HASH[Dom.TOEP], dtype=np.uint64),
    )
    toep_nonces = toep_base ^ dom_hashes

    if engine is not None and engine.s32_dev is not None:
        r_dev, rej_dev = engine.prf_cores_async(
            keys, nonces, toep_keys, toep_nonces
        )

        def fetch():
            return np.asarray(r_dev), np.asarray(rej_dev)[:, None]
    else:
        from .. import native

        ks = native.aes256_ctr(keys, nonces, nblocks)
        if ks is not None:
            u64s = ks.view(U32).reshape(N, 2 * nblocks, 2)
            top_u = native.aes256_ctr(toep_keys, toep_nonces, 1).view(
                U32).reshape(N, 2, 2)
        else:
            u64s = aesv.ctr_keystream_u64(keys, nonces, nblocks)
            top_u = aesv.ctr_keystream_u64(toep_keys, toep_nonces, 1)
        r0, rej0 = cores_from_streams(
            u64s, top_u, sk.s_words32().reshape(-1), prm
        )

        def fetch():
            return r0, rej0

    return _prf_finalize(pk, sk, seeds_u64, dom_hashes, fetch)


def _prf_finalize(pk: PubKey, sk: SecKey, seeds_u64, dom_hashes, fetch):
    def finalize():
        r, rej = fetch()
        # exact fallback for bounded-rejection lanes
        # (probability ~ rows*den/2^64)
        if rej.any():
            for n in np.nonzero(rej.any(axis=-1))[0]:
                seed = RSeed(
                    int(seeds_u64[n, 0]),
                    type("N", (), {
                        "lo": int(seeds_u64[n, 1]),
                        "hi": int(seeds_u64[n, 2]),
                    })(),
                )
                r[n] = _prf_core_exact_scalar(pk, sk, seed, int(dom_hashes[n]))
        return r

    return finalize


def prf_cores_batch(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                    dom_hashes: np.ndarray) -> np.ndarray:
    """Synchronous prf_cores_batch_start: dispatch + finalize in one call."""
    return prf_cores_batch_start(pk, sk, seeds_u64, dom_hashes)()


def _prf_core_exact_scalar(pk: PubKey, sk: SecKey, seed, dom_hash: int) -> np.ndarray:
    """Slow exact mirror used only when a bounded() rejection occurred."""
    dom = next(d for d, h in DOM_HASH.items() if h == dom_hash)
    yb = lpn_make_ybits(pk, sk, seed, dom)
    key, nonce = _toep_key_nonce(pk, sk, seed, dom)
    prg = AES.AesCtr256(key, nonce)
    top_words = prg.fill_u64((pk.prm.lpn_t + 127 + 63) // 64)
    lo, hi = TOEP.toep_127_scalar(top_words, yb)
    v = hash_to_fp_nonzero(lo, hi)
    return FV.from_ints([v])[0]


def prf_R_batch(pk: PubKey, sk: SecKey, seeds_u64: np.ndarray,
                noise: bool = False) -> np.ndarray:
    """Batched prf_R / prf_R_noise over N seeds -> [N, 4] uint32 limbs."""
    N = seeds_u64.shape[0]
    doms = (Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3) if noise else (
        Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3)
    seeds3 = np.repeat(seeds_u64, 3, axis=0)
    dh = np.tile(np.array([DOM_HASH[d] for d in doms], dtype=np.uint64), N)
    cores = prf_cores_batch(pk, sk, seeds3, dh).reshape(N, 3, 4)
    return FV.mul(FV.mul(cores[:, 0], cores[:, 1]), cores[:, 2])
