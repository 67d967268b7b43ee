"""Hypergraph / syndrome machinery (reference: include/pvac/crypto/matrix.hpp).

- prg_choose_k: k unique indices from a SHA-256-CTR stream (matrix.hpp:15-92)
- gen_ubk_public: public Fisher-Yates permutation from canon_tag (:95-164)
- apply_perm_sigma / ubk_apply: bit permutation of syndromes (:167-188, :306-310)
- gen_H: n_bits sparse columns of m_bits, col weight h_col_wt, plus the
  streaming H digest (:191-251)
- prg_layer_ztag: layer tag hash (:254-264)
- sigma_from_H: XOR of x_col_wt H-columns + err_wt noise bits (:267-303)

H is stored as a packed uint32 bit matrix [n_bits, m_words32]; σ generation
is batched over edges (gather + XOR-reduce), matching the reference
bit-for-bit via the shared SHA-CTR stream semantics.
"""
from __future__ import annotations

import struct

import numpy as np

from ..core import bitvec as BV
from ..core import hash as H
from ..types import Cipher, Dom, Nonce128, PubKey, Ubk
from . import shactr

U32 = np.uint32


def prg_choose_k(k: int, N: int, label: str, words) -> list[int]:
    """Scalar prg_choose_k (matrix.hpp:15-92)."""
    return shactr.choose_k_scalar(k, N, label, words)


def gen_ubk_public(canon_tag: int, m_bits: int) -> Ubk:
    """Public permutation from canon_tag (matrix.hpp:95-164)."""
    perm = list(range(m_bits))
    rng = shactr.CtrStream("UBK", [canon_tag])
    for i in range(m_bits - 1, 0, -1):
        j = rng.bounded(i + 1)
        perm[i], perm[j] = perm[j], perm[i]
    perm = np.asarray(perm, dtype=np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(m_bits, dtype=np.int32)
    return Ubk(perm=perm, inv=inv)


def apply_perm_sigma(sigma, inv) -> np.ndarray:
    """Permute σ bits: out[inv[src]] = in[src], i.e. out[j] = in[perm[j]]
    (matrix.hpp:167-188).  sigma: [..., W] uint32 packed; inv: int32 [m]."""
    xp = np if type(sigma).__module__.startswith("numpy") else __import__(
        "jax.numpy", fromlist=["x"]
    )
    m = inv.shape[0]
    # perm[j] = src such that inv[src] = j
    if isinstance(inv, np.ndarray):
        perm = np.empty_like(inv)
        perm[inv] = np.arange(m, dtype=inv.dtype)
    else:
        perm = xp.zeros_like(inv).at[inv].set(xp.arange(m, dtype=inv.dtype))
    src_word = perm // 32
    src_bit = (perm % 32).astype(U32)
    bits = (sigma[..., src_word] >> src_bit) & U32(1)  # [..., m]
    out = bits.reshape(*bits.shape[:-1], m // 32, 32)
    sh = xp.arange(32, dtype=U32)
    return (out << sh).sum(axis=-1, dtype=np.uint64).astype(U32) if xp is np else (
        (out << sh).sum(axis=-1).astype(U32)
    )


def ubk_apply(pk: PubKey, C: Cipher) -> None:
    """Permute every edge's σ in place (matrix.hpp:306-310)."""
    if C.n_edges:
        C.sigma = apply_perm_sigma(np.asarray(C.sigma), pk.ubk.inv)


def gen_H(pk: PubKey) -> None:
    """Generate H columns + digest into pk (matrix.hpp:191-251)."""
    prm = pk.prm
    m, n, wt = prm.m_bits, prm.n_bits, prm.h_col_wt
    mw = prm.sigma_words32

    # per-column stream words: {m, n, wt, c, canon_tag}
    cols = np.arange(n, dtype=np.uint64)
    words = np.zeros((n, 5), dtype=np.uint64)
    words[:, 0] = m
    words[:, 1] = n
    words[:, 2] = wt
    words[:, 3] = cols
    words[:, 4] = pk.canon_tag
    lanes = np.stack(
        [(words & np.uint64(0xFFFFFFFF)).astype(U32),
         (words >> np.uint64(32)).astype(U32)],
        axis=-1,
    )
    from .. import native

    rows_idx = native.choose_k(Dom.H_GEN.encode(), words, wt, m)
    if rows_idx is None:
        rows_idx, fb = shactr.choose_k_batch(wt, m, Dom.H_GEN, lanes)
        if fb.any():
            for c in np.nonzero(fb)[0]:
                rows_idx[c] = shactr.choose_k_scalar(
                    wt, m, Dom.H_GEN, [m, n, wt, int(c), pk.canon_tag]
                )

    Hbits = np.zeros((n, mw), dtype=U32)
    col_ids = np.repeat(np.arange(n), wt)
    r = rows_idx.reshape(-1)
    np.bitwise_or.at(Hbits, (col_ids, r // 32), U32(1) << (r % 32).astype(U32))
    pk.H = Hbits

    # streaming digest: "H|v2" + m,n,wt (le64) + column bytes
    hsh = __import__("hashlib").sha256()
    hsh.update(b"H|v2")
    hsh.update(struct.pack("<QQQ", m, n, wt))
    nbytes = (m + 7) // 8
    hsh.update(Hbits.astype("<u4").tobytes()[: n * mw * 4] if nbytes == mw * 4
               else _column_bytes(Hbits, nbytes))
    pk.H_digest = hsh.digest()


def _column_bytes(Hbits: np.ndarray, nbytes: int) -> bytes:
    full = Hbits.astype("<u4").tobytes()
    mwb = Hbits.shape[1] * 4
    out = bytearray()
    for c in range(Hbits.shape[0]):
        out += full[c * mwb : c * mwb + nbytes]
    return bytes(out)


def prg_layer_ztag(canon_tag: int, nonce: Nonce128) -> int:
    """Layer tag (matrix.hpp:254-264)."""
    msg = Dom.ZTAG.encode() + struct.pack(
        "<QQQ", canon_tag & shactr.U64MAX, nonce.lo & shactr.U64MAX,
        nonce.hi & shactr.U64MAX,
    )
    return struct.unpack("<Q", H.sha256(msg)[:8])[0]


def sigma_words_start(pk: PubKey, ztag, nonce_lo, nonce_hi, idx, ch, salt,
                      tab=None):
    """Batched sigma_from_H (matrix.hpp:267-303) over E edges, split into
    dispatch + finalize so callers can overlap other work with the device
    computation.

    All arguments after pk are arrays [E] (uint64-compatible).  ``tab``
    optionally carries ``(ltab [U, 3] u64, lid [E])`` with
    ``ltab[lid] == stack([ztag, nonce_lo, nonce_hi], -1)`` — callers that
    already own the layer seed table pass it so the engine path skips a
    structured-sort dedup.  Returns a zero-arg finalize() ->
    [E, m_words32] uint32 packed syndromes (a device-resident jax array on
    the engine path)."""
    prm = pk.prm
    E = len(ztag)
    words = np.zeros((E, 7), dtype=np.uint64)
    words[:, 0] = pk.canon_tag
    words[:, 1] = ztag
    words[:, 2] = nonce_lo
    words[:, 3] = nonce_hi
    words[:, 4] = idx
    words[:, 5] = ch
    words[:, 6] = salt
    engine = getattr(pk, "_engine", None)
    if engine is not None and engine.H_dev is not None:
        sig, fb, rows = engine.sigma(words, tab=tab)
        return SigmaJob(pk, prm, words, sig, fb, rows)
    else:
        from .. import native

        cols = native.choose_k(Dom.X_SEED.encode(), words, prm.x_col_wt, prm.n_bits)
        noise = (None if cols is None else
                 native.choose_k(Dom.NOISE.encode(), words, prm.err_wt, prm.m_bits))
        if noise is not None:
            fb = np.zeros(E, dtype=bool)  # native path handles rejections
        else:
            lanes = np.stack(
                [(words & np.uint64(0xFFFFFFFF)).astype(U32),
                 (words >> np.uint64(32)).astype(U32)],
                axis=-1,
            )
            cols, fb1 = shactr.choose_k_batch(prm.x_col_wt, prm.n_bits, Dom.X_SEED, lanes)
            noise, fb2 = shactr.choose_k_batch(prm.err_wt, prm.m_bits, Dom.NOISE, lanes)
            fb = fb1 | fb2
        # XOR of the selected H columns + err_wt unique single noise bits
        # (unique => OR == XOR); native streams H rows, numpy materializes
        # the [E, k, mw] gather
        sig = native.sigma_xor(pk.H, cols, noise)
        if sig is None:
            sig = np.bitwise_xor.reduce(pk.H[cols], axis=1)  # [E, mw]
            eids = np.repeat(np.arange(E), prm.err_wt)
            r = noise.reshape(-1)
            np.bitwise_xor.at(sig, (eids, r // 32),
                              U32(1) << (r % 32).astype(U32))

    return SigmaJob(pk, prm, words, sig, fb)


class SigmaJob:
    """A dispatched σ batch: device-resident (sig, fb) plus the host word
    fields needed for scalar fallback recomputation.  Callable for
    single-job use; :func:`sigma_finalize_many` fetches many jobs' fallback
    flags in one device round trip.

    On the engine path sig/fb keep the dispatch padding and ``rows``
    (host int64) indexes the valid lanes (engine.sigma docstring explains
    why); host-path jobs have exact arrays and ``rows is None``."""

    __slots__ = ("pk", "prm", "words", "sig", "fb", "rows")

    def __init__(self, pk, prm, words, sig, fb, rows=None):
        self.pk = pk
        self.prm = prm
        self.words = words
        self.sig = sig
        self.fb = fb
        self.rows = rows

    @property
    def n_pad(self) -> int:
        """Length of the (possibly padded) sig/fb arrays."""
        return int(self.sig.shape[0])

    def _valid_fb(self, fb_padded: np.ndarray) -> np.ndarray:
        return fb_padded if self.rows is None else fb_padded[self.rows]

    def _apply_fallbacks(self, fbh: np.ndarray):
        """fbh: fallback flags in VALID-lane coordinates [E]."""
        if not isinstance(self.sig, np.ndarray) or self.rows is not None:
            sig = np.asarray(self.sig)
            if self.rows is not None:
                sig = sig[self.rows]
            self.sig = sig
            self.rows = None
        if fbh.any():
            if not self.sig.flags.writeable:
                self.sig = self.sig.copy()
            for e in np.nonzero(fbh)[0]:
                self.sig[e] = _scalar_sigma_row(
                    self.pk, self.prm, self.words[e])
        return self.sig

    def __call__(self):
        return self._apply_fallbacks(self._valid_fb(np.asarray(self.fb)))


def _scalar_sigma_row(pk, prm, wrow) -> np.ndarray:
    """Reference-exact σ for one edge via the scalar draw path
    (fallback for lanes the vectorized overshoot window couldn't serve)."""
    w = [int(wrow[j]) for j in range(7)]
    c = shactr.choose_k_scalar(prm.x_col_wt, prm.n_bits, Dom.X_SEED, w)
    nn = shactr.choose_k_scalar(prm.err_wt, prm.m_bits, Dom.NOISE, w)
    v = np.bitwise_xor.reduce(pk.H[c], axis=0)
    for rr in nn:
        v[rr // 32] ^= U32(1 << (rr % 32))
    return v


class SigmaFallbackFixer:
    """Deferred fallback patching for a set of dispatched σ jobs whose
    outputs are concatenated (in job order) into one LazySigma base.

    The fallback flags are NOT fetched at creation — producers return
    device-resident σ with zero synchronization, and the single flag fetch
    (a host sync) happens lazily on the first σ materialization.  Flagged lanes (bounded rejection or overshoot
    exhaustion in the vectorized draws — both vanishingly rare) are then
    recomputed with the reference-exact scalar path and patched into the
    materialized rows.

    All row bookkeeping is in BASE coordinates — the concatenation of the
    jobs' (possibly padded) sig arrays, matching the LazySigma base."""

    __slots__ = ("jobs", "offs", "_patches")

    def __init__(self, jobs):
        self.jobs = jobs
        offs = [0]
        for j in jobs:
            offs.append(offs[-1] + j.n_pad)
        self.offs = offs
        self._patches = None

    def _resolve(self) -> dict:
        if self._patches is None:
            fbs = [j.fb for j in self.jobs]
            if any(not isinstance(f, np.ndarray) for f in fbs):
                import jax.numpy as jnp

                cat = np.asarray(
                    jnp.concatenate(fbs) if len(fbs) > 1 else fbs[0]
                )
            else:
                cat = np.concatenate(fbs) if len(fbs) > 1 else fbs[0]
            patches = {}
            for j, off in zip(self.jobs, self.offs):
                fbj = j._valid_fb(cat[off : off + j.n_pad])
                for e in np.nonzero(fbj)[0]:
                    base_row = off + (int(e) if j.rows is None
                                      else int(j.rows[e]))
                    patches[base_row] = _scalar_sigma_row(
                        j.pk, j.prm, j.words[e]
                    )
            self._patches = patches
            # The patches carry everything needed from here on; release the
            # jobs so their device σ buffers and host word tables are not
            # pinned for the lifetime of every derived LazySigma.
            self.jobs = None
        return self._patches

    def __call__(self, out: np.ndarray, rows: np.ndarray) -> np.ndarray:
        patches = self._resolve()
        if not patches:
            return out
        pr = np.fromiter(patches.keys(), dtype=np.int64)
        hits = np.nonzero(np.isin(rows, pr))[0]
        if hits.size:
            if not out.flags.writeable:
                out = out.copy()
            for i in hits:
                out[i] = patches[int(rows[i])]
        return out


def sigma_deferred(jobs: list["SigmaJob"]):
    """Zero-synchronization finalize: per-job σ bases (device-resident on
    the engine path, padded, unpatched) plus a shared
    :class:`SigmaFallbackFixer` and the BASE-coordinate valid-row indices
    [E_total] to hand to the LazySigma views over their concatenation.
    Host-path jobs (fb already an ndarray) still participate — their flags
    cost nothing to read and the fixer handles them uniformly."""
    row_parts = []
    off = 0
    for j in jobs:
        row_parts.append(
            off + (np.arange(j.n_pad, dtype=np.int64)
                   if j.rows is None else j.rows)
        )
        off += j.n_pad
    rows = (np.concatenate(row_parts) if row_parts
            else np.zeros(0, dtype=np.int64))
    return [j.sig for j in jobs], SigmaFallbackFixer(jobs), rows


def sigma_finalize_many(jobs: list["SigmaJob"]) -> list:
    """Finalize many dispatched σ jobs with ONE fallback-flag fetch
    (each np.asarray(fb) is a host sync)."""
    if not jobs:
        return []
    dev_jobs = [j for j in jobs if not isinstance(j.fb, np.ndarray)]
    if len(dev_jobs) > 1:
        import jax.numpy as jnp

        cat = np.asarray(jnp.concatenate([j.fb for j in dev_jobs]))
        off = 0
        for j in dev_jobs:
            n = j.n_pad
            j.fb = cat[off : off + n]
            off += n
    return [j() for j in jobs]


def sigma_words(pk: PubKey, ztag, nonce_lo, nonce_hi, idx, ch, salt) -> np.ndarray:
    """Synchronous sigma_words_start: dispatch + finalize in one call."""
    return sigma_words_start(pk, ztag, nonce_lo, nonce_hi, idx, ch, salt)()


def sigma_from_H(pk: PubKey, ztag: int, nonce: Nonce128, idx: int, ch: int,
                 salt: int) -> np.ndarray:
    """Scalar wrapper -> [m_words32] uint32."""
    return sigma_words(
        pk,
        np.array([ztag], dtype=np.uint64),
        np.array([nonce.lo], dtype=np.uint64),
        np.array([nonce.hi], dtype=np.uint64),
        np.array([idx], dtype=np.uint64),
        np.array([ch], dtype=np.uint64),
        np.array([salt], dtype=np.uint64),
    )[0]
