"""Homomorphic arithmetic (reference: include/pvac/ops/arithmetic.hpp).

ct_add/sub/neg/scale are metadata + limb-vector operations; ct_mul's edge
cross product and (layer-pair, idx mod B) bucket aggregation — the hot O(n^2)
loop (arithmetic.hpp:79-87) — runs as batched limb multiplies with limb-wise
uint64 segment sums, then one batched σ regeneration for the emitted edges.
"""
from __future__ import annotations

import numpy as np

import os

from ..core import field as F
from ..core import fieldv as FV
from ..core.random import csprng_u64, csprng_u64_array
from ..crypto import matrix
from ..types import (
    Cipher, Layer, LazySigma, Nonce128, PubKey, RSeed, VirtualSigma,
    RRULE_PROD, SGN_P, SGN_M, make_nonce128,
)
from .encrypt import combine_ciphers, compact_layers, guard_budget

U32 = np.uint32


def ct_add(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    """Concatenation add (arithmetic.hpp:12-31) — same as combine_ciphers."""
    return combine_ciphers(pk, A, B)


def ct_add_batch(pk: PubKey,
                 pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_add (reference op: arithmetic.hpp:12-31, one call per
    pair there).  Semantically identical to ``[ct_add(pk, a, b) for ...]``;
    the per-pair Python/numpy dispatch overhead (the one op where this
    framework trailed the single-threaded reference) amortizes by doing
    ONE concatenate per edge column across the whole batch and handing each
    output a zero-copy view."""
    if not pairs:
        return []
    return _add_batch(pk, pairs, negate_b=False)


def _add_batch(pk: PubKey, pairs: list[tuple[Cipher, Cipher]],
               negate_b: bool) -> list[Cipher]:
    from ..types import StackedSigma

    hostish = (np.ndarray, StackedSigma)
    fast = all(
        isinstance(a.sigma, hostish) and isinstance(b.sigma, hostish)
        for a, b in pairs
    )
    if not fast:
        if negate_b:
            return [ct_add(pk, a, ct_neg(pk, b)) for a, b in pairs]
        return [ct_add(pk, a, b) for a, b in pairs]
    lid_parts, idx_parts, ch_parts, w_parts, sg_parts = [], [], [], [], []
    layers_list, sizes, part_off, part_sz = [], [], [], []
    # Per-input caches keyed by id(): pairs lists routinely repeat the same
    # ciphertexts, and the PROD scan / Layer copies are per-INPUT work.
    has_prod: dict[int, bool] = {}

    def _prodp(c):
        v = has_prod.get(id(c))
        if v is None:
            v = any(L.rule == RRULE_PROD for L in c.layers)
            has_prod[id(c)] = v
        return v

    for a, b in pairs:
        la, lb = a.layers, b.layers
        off = len(la)
        # BASE Layer objects are immutable in practice and safe to share;
        # PROD layers get pa/pb rewritten by compact_layers, so copy them.
        al = (
            [Layer(L.rule, L.seed, L.pa, L.pb)
             if L.rule == RRULE_PROD else L for L in la]
            if _prodp(a) else la
        )
        bl = (
            [Layer(L.rule, L.seed, L.pa + off, L.pb + off)
             if L.rule == RRULE_PROD else L for L in lb]
            if _prodp(b) else lb
        )
        layers_list.append(al + bl)
        na = a.layer_id.shape[0]
        nb = b.layer_id.shape[0]
        lid_parts.append(a.layer_id)
        lid_parts.append(b.layer_id)
        part_off.append(0)
        part_off.append(off)
        part_sz.append(na)
        part_sz.append(nb)
        idx_parts.append(a.idx)
        idx_parts.append(b.idx)
        ch_parts.append(a.ch)
        ch_parts.append(b.ch)
        w_parts.append(a.w)
        w_parts.append(b.w)
        # σ stays zero-copy: [A.sigma; B.sigma] as a StackedSigma view
        # (the 1 KB/edge memcpy at default Params was ct_add's entire cost)
        sa = a.sigma.parts if isinstance(a.sigma, StackedSigma) else [a.sigma]
        sb = b.sigma.parts if isinstance(b.sigma, StackedSigma) else [b.sigma]
        sg_parts.append(StackedSigma(sa + sb))
        sizes.append(na + nb)
    starts = np.zeros(len(pairs) + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    lid_all = np.concatenate(lid_parts)
    lid_all += np.repeat(np.asarray(part_off, dtype=np.int32),
                         part_sz).astype(np.int32)
    idx_all = np.concatenate(idx_parts)
    ch_all = np.concatenate(ch_parts)
    w_all = np.concatenate(w_parts)
    if negate_b:
        # sub = add with every B-side weight negated; parts alternate
        # [a0, b0, a1, b1, ...] so one repeat-mask selects all B rows and
        # ONE field multiply negates them across the whole batch
        # (reference: arithmetic.hpp:43-45 does per-edge fp_mul per call).
        bmask = np.repeat(
            np.tile(np.array([False, True]), len(pairs)), part_sz)
        bw = w_all[bmask]
        neg1 = np.broadcast_to(FV.from_ints([F.P - 1])[0], bw.shape)
        w_all[bmask] = FV.mul(bw, neg1)
    # Batch-wide layer-liveness precheck: compact_layers (mandatory per the
    # reference, arithmetic.hpp:29) is a no-op whenever every layer is
    # directly edge-referenced.  One bincount over globalized layer ids
    # decides that for ALL pairs at once.
    lcounts = np.array([len(ls) for ls in layers_list], dtype=np.int64)
    lstarts = np.zeros(len(pairs) + 1, dtype=np.int64)
    np.cumsum(lcounts, out=lstarts[1:])
    gid = lid_all + np.repeat(lstarts[:-1], sizes)
    alive = np.bincount(gid, minlength=int(lstarts[-1])) > 0
    if (lcounts == 0).any():  # degenerate empty cts: reduceat can't segment
        all_live = np.zeros(len(pairs), dtype=bool)
    else:
        all_live = np.logical_and.reduceat(alive, lstarts[:-1])
    budget = pk.prm.edge_budget
    out = []
    new = Cipher.__new__
    for i in range(len(pairs)):
        s, e = starts[i], starts[i + 1]
        C = new(Cipher)  # raw init: columns are known-typed views
        C.layers = layers_list[i]
        C.layer_id = lid_all[s:e]
        C.idx = idx_all[s:e]
        C.ch = ch_all[s:e]
        C.w = w_all[s:e]
        C.sigma = sg_parts[i]
        if sizes[i] > budget:
            guard_budget(pk, C, "add")
        if not all_live[i]:
            compact_layers(C)
        out.append(C)
    return out


def ct_sub_batch(pk: PubKey,
                 pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_sub = ct_add_batch with every B-side weight negated in
    ONE field multiply across the batch (reference: arithmetic.hpp:43-45)."""
    if not pairs:
        return []
    return _add_batch(pk, pairs, negate_b=True)


def ct_scale(pk: PubKey, A: Cipher, s: int) -> Cipher:
    """Multiply every edge weight by a scalar (arithmetic.hpp:33-37)."""
    C = A.copy()
    sv = np.broadcast_to(FV.from_ints([s])[0], C.w.shape)
    C.w = FV.mul(C.w, sv)
    return C


def ct_neg(pk: PubKey, A: Cipher) -> Cipher:
    return ct_scale(pk, A, F.P - 1)


def ct_sub(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    return ct_add(pk, A, ct_neg(pk, B))


def ct_div_const(pk: PubKey, A: Cipher, k: int) -> Cipher:
    return ct_scale(pk, A, F.fp_inv(k))


def ct_mul_batch(pk: PubKey, pairs: list[tuple[Cipher, Cipher]]) -> list[Cipher]:
    """Batched ct_mul, software-pipelined: host staging (cross product +
    bucket sums) of product i+1 overlaps the device σ generation of the
    edges staged so far.  σ work is dispatched in exact SIGMA_CHUNK-lane
    slices (no per-product padding); the remainder pads once at the end."""
    CH = 16384
    staged = []
    pend = []          # per-product (zt, nlo, nhi, idx, ch, salt) blocks
    pend_n = 0
    finals = []        # (finalize, n_lanes) in dispatch order

    def _dispatch(nlanes: int) -> None:
        """Concatenate pending blocks and dispatch the first nlanes of them;
        keep any remainder pending."""
        nonlocal pend, pend_n
        cat = [np.concatenate([b[j] for b in pend]) for j in range(6)]
        # merge the per-stage layer seed tables: each block's lid indexes
        # its own ltab, so shift by the running row offset
        ltab = np.vstack([b[6] for b in pend])
        off = 0
        lids = []
        for b in pend:
            lids.append(b[7] + off)
            off += b[6].shape[0]
        lid = np.concatenate(lids)
        rem = [c[nlanes:] for c in cat]
        lid_rem = lid[nlanes:]
        cat = [c[:nlanes] for c in cat]
        fin = matrix.sigma_words_start(
            pk, cat[0], cat[1], cat[2], cat[3], cat[4], cat[5],
            tab=(ltab, lid[:nlanes]),
        )
        finals.append((fin, nlanes))
        pend = ([tuple(rem) + (ltab, lid_rem)] if rem[0].size else [])
        pend_n = int(rem[0].shape[0])

    # Products beyond this edge count keep σ VIRTUAL (recipe-backed,
    # generated on first read) instead of eagerly generating m_bits/edge:
    # σ is camouflage that op chains never read, and eager generation is
    # what kills the reference's own depth test at step 4 (std::bad_alloc
    # at 44M edges).  Bit-identical on materialization.
    eager_max = int(os.environ.get("PVAC_SIGMA_EAGER_MAX", str(1 << 21)))

    # Phase 1: start all stagings.  Device-grid products (big edge sets)
    # dispatch their int8-matmul programs here and run concurrently; host products
    # compute inline.  Phase 2 finalizes in order and feeds the σ pipeline.
    starts = [_ct_mul_stage_start(pk, A, B) for A, B in pairs]
    for fin in starts:
        s = fin()
        staged.append(s)
        n = len(s["out_lid"])
        if n > eager_max and len(s["layers"]) < (1 << 21):
            ltab = np.array(
                [[L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi]
                 for L in s["layers"]],
                dtype=np.uint64,
            )
            packed = (
                (s["out_lid"].astype(np.uint32) << U32(11))
                | (s["out_idx"].astype(np.uint32) << U32(1))
                | s["out_ch"].astype(np.uint32)
            )
            s["vsigma"] = VirtualSigma(
                pk, ltab, packed, np.asarray(csprng_u64_array(n),
                                             dtype=np.uint64)
            )
        elif n:
            zt, nlo, nhi, ltab, lid = _stage_seed_words(s)
            pend.append((
                zt, nlo, nhi,
                s["out_idx"].astype(np.uint64),
                s["out_ch"].astype(np.uint64),
                csprng_u64_array(n),
                ltab, lid,
            ))
            pend_n += n
            if pend_n >= CH:
                _dispatch((pend_n // CH) * CH)
    if pend_n:
        _dispatch(pend_n)

    counts = [0 if "vsigma" in s else len(s["out_lid"]) for s in staged]
    fixer = None
    vrows = None
    if sum(counts):
        jobs = [fin for fin, _ in finals]
        if any(not isinstance(j.sig, np.ndarray) for j in jobs):
            # device σ: return immediately with NO flag fetch — the single
            # round-trip synchronization moves into the LazySigma fixup,
            # paid only if/when σ is actually materialized on the host
            parts, fixer, vrows = matrix.sigma_deferred(jobs)
            import jax.numpy as jnp

            sig_all = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        else:
            parts = matrix.sigma_finalize_many(jobs)
            sig_all = parts[0] if len(parts) == 1 else np.concatenate(parts)
    out = []
    off = 0
    for s, n in zip(staged, counts):
        mw = pk.prm.sigma_words32
        if "vsigma" in s:
            sig = s["vsigma"]
        elif n == 0:
            sig = np.zeros((0, mw), dtype=U32)
        elif isinstance(sig_all, np.ndarray):
            sig = sig_all[off : off + n]
        else:
            # lazy view: no eager device slice (compile churn + round trips
            # on a high-latency link); σ materializes only if read on host.
            # vrows maps valid-edge order -> rows of the padded base.
            sig = LazySigma(sig_all, vrows[off : off + n], fixer)
        off += n
        C = Cipher(
            s["layers"],
            s["out_lid"],
            s["out_idx"],
            s["out_ch"],
            s["out_w"],
            sig,
        )
        guard_budget(pk, C, "mul")
        compact_layers(C)
        out.append(C)
    return out


# Above this many edge pairs the host O(|A|*|B|) aggregation loses to the
# device dense-grid path (parallel/mulgrid.py), whose cost scales with the
# layer grid LA*LB*B^2 instead.
MULGRID_PAIR_THRESHOLD = 1 << 20

# ... unless the native threaded dense-bucket aggregator applies: up to
# this many pairs it takes the product instead of the device grid.  The
# split has not been measured on the GPU.
NATIVE_AGG_PAIR_MAX = int(
    os.environ.get("PVAC_NATIVE_AGG_PAIR_MAX", str(1 << 28)))


def _native_agg_viable(LA: int, LB: int, Bmod: int, npairs: int) -> bool:
    from .. import native

    if native.lib() is None:
        return False
    keyspace = LA * LB * Bmod * 2
    return 0 < keyspace <= native.CROSS_AGG_KEYSPACE_MAX \
        and npairs <= NATIVE_AGG_PAIR_MAX


def _agg_slots(C: Cipher, Bmod: int):
    """Pre-aggregate edges by (layer, sign, idx) slot: weights field-sum.

    slot = (layer*2 + sign)*B + idx — the dense-grid layout of mulgrid.py.
    Valid as a ct_mul preprocessing step because the reference's pair key
    (arithmetic.hpp:81) depends only on each edge's slot.
    """
    key = ((C.layer_id.astype(np.int64) * 2 + C.ch) * Bmod
           + C.idx.astype(np.int64))
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros((len(uniq), 4), dtype=np.uint64)
    np.add.at(acc, inv, C.w.astype(np.uint64))

    from .. import native

    red = native.reduce_u64_limbs(acc)
    if red is None:
        red = FV.canon_u64_limbs(acc)
    return uniq.astype(np.int32), red


def _mul_layers(pk: PubKey, A: Cipher, B: Cipher):
    """PROD layer grid construction (arithmetic.hpp:50-70)."""
    LA, LB = A.n_layers, B.n_layers
    layers = [Layer(L.rule, L.seed, L.pa, L.pb) for L in A.layers]
    off = LA
    for L in B.layers:
        if L.rule == RRULE_PROD:
            layers.append(Layer(L.rule, L.seed, L.pa + off, L.pb + off))
        else:
            layers.append(Layer(L.rule, L.seed, L.pa, L.pb))
    base = len(layers)
    for la in range(LA):
        for lb in range(LB):
            nonce = make_nonce128()
            seed = RSeed(matrix.prg_layer_ztag(pk.canon_tag, nonce), nonce)
            layers.append(Layer(RRULE_PROD, seed, la, off + lb))
    return layers, base


def _stage_dict(layers, base, out_lid, out_idx, out_ch, out_w):
    return {
        "layers": layers,
        "base": base,
        "out_lid": out_lid,
        "out_idx": out_idx,
        "out_ch": out_ch,
        "out_w": out_w,
    }


def _stage_seed_words(s):
    """Per-edge (ztag, nonce_lo, nonce_hi) for the eager σ pipeline —
    gathered lazily so virtual-σ products never build the [E] u64 arrays.
    Also returns the PROD-layer seed table [L-base, 3] and per-edge rows
    into it (every product edge lives in a PROD grid layer, lid >= base),
    so the σ dispatch can skip re-deduplicating the triples."""
    layers = s["layers"]
    base = s.get("base", 0)
    ltab = np.array(
        [[L.seed.ztag, L.seed.nonce.lo, L.seed.nonce.hi]
         for L in layers[base:]],
        dtype=np.uint64,
    ).reshape(len(layers) - base, 3)
    lid = s["out_lid"] - base
    trip = ltab[lid]
    return trip[:, 0], trip[:, 1], trip[:, 2], ltab, lid


def _ct_mul_stage_start(pk: PubKey, A: Cipher, B: Cipher):
    """Start one ct_mul staging; returns finalize() -> staged dict.

    Big products route the cross-product + bucket reduction through the
    device dense-grid program (dispatched here, fetched in finalize);
    small ones aggregate on the host inline.
    """
    LA, LB = A.n_layers, B.n_layers
    layers, base = _mul_layers(pk, A, B)
    nA, nB = A.n_edges, B.n_edges
    Bmod = pk.prm.B

    engine = getattr(pk, "_engine", None)
    if (engine is not None and nA * nB >= MULGRID_PAIR_THRESHOLD
            and not _native_agg_viable(LA, LB, Bmod, nA * nB)):
        return _stage_device(pk, engine, A, B, layers, base)

    def finalize_host():
        return _ct_mul_stage_host(pk, layers, base, A, B)

    return finalize_host


# Device-grid layer-block size: the grid program's device-memory footprint
# grows with LA*LB (XLA keeps several [LA*2, D7, LB*2, B] s32 dot temps live
# across the unrolled digit loop), so big products run as a grid of
# <=LBLOCK x LBLOCK layer blocks.
MULGRID_LBLOCK = 32


def _stage_device(pk: PubKey, engine, A: Cipher, B: Cipher, layers, base):
    """Dense-grid staging on the device: remap to OCCUPIED layers (empty
    layers would only pad the grid), block the layer axes at MULGRID_LBLOCK,
    dispatch every block now, fetch in finalize."""
    LB_all = B.n_layers
    Bmod = pk.prm.B
    sA, wA = _agg_slots(A, Bmod)
    sB, wB = _agg_slots(B, Bmod)
    occA = np.unique(sA // (2 * Bmod)).astype(np.int64)
    occB = np.unique(sB // (2 * Bmod)).astype(np.int64)
    # slot remapped to occupied-layer rank
    rA = np.searchsorted(occA, sA // (2 * Bmod))
    rB = np.searchsorted(occB, sB // (2 * Bmod))
    relA = rA * 2 * Bmod + sA % (2 * Bmod)
    relB = rB * 2 * Bmod + sB % (2 * Bmod)

    LBLK = MULGRID_LBLOCK
    blocks = []
    for a0 in range(0, len(occA), LBLK):
        a1 = min(len(occA), a0 + LBLK)
        mA = (rA >= a0) & (rA < a1)
        bsA = (relA[mA] - a0 * 2 * Bmod).astype(np.int32)
        bwA = wA[mA]
        for b0 in range(0, len(occB), LBLK):
            b1 = min(len(occB), b0 + LBLK)
            mB = (rB >= b0) & (rB < b1)
            fin = engine.mulgrid.start(
                bsA, bwA, a1 - a0,
                (relB[mB] - b0 * 2 * Bmod).astype(np.int32), wB[mB], b1 - b0,
            )
            blocks.append((a0, b0, fin))

    def finalize():
        lids, idxs, chs, ws = [], [], [], []
        for a0, b0, fin in blocks:
            ow, nzm = fin()
            la, lb, c, s = np.nonzero(nzm)
            lids.append(
                (base + occA[a0 + la] * LB_all + occB[b0 + lb]).astype(np.int32)
            )
            idxs.append(c.astype(np.int32))
            chs.append(s.astype(np.int8))  # axis order [SGN_P, SGN_M]
            ws.append(ow[la, lb, c, s])
        out_lid = np.concatenate(lids)
        out_idx = np.concatenate(idxs)
        out_ch = np.concatenate(chs)
        out_w = np.concatenate(ws)
        return _stage_dict(layers, base, out_lid, out_idx, out_ch, out_w)

    return finalize


def _ct_mul_stage_host(pk: PubKey, layers, base, A: Cipher, B: Cipher) -> dict:
    """Host cross-product aggregation (small products)."""
    LA, LB = A.n_layers, B.n_layers
    nA, nB = A.n_edges, B.n_edges
    Bmod = pk.prm.B

    from .. import native

    got = native.mul_cross_agg(
        A.layer_id, A.idx, A.ch, A.w, B.layer_id, B.idx, B.ch, B.w,
        LA, LB, Bmod,
    )
    if got is not None:
        ks, out_w = got
        out_lid = (base + (ks // 2) // Bmod).astype(np.int32)
        out_idx = ((ks // 2) % Bmod).astype(np.int32)
        out_ch = np.where((ks & 1) == 0, SGN_P, SGN_M).astype(np.int8)
        return _stage_dict(layers, base, out_lid, out_idx, out_ch, out_w)

    # Cross product in chunks of A-edges: bounds peak memory at
    # ~chunk*nB pair rows regardless of ciphertext size.
    chunk = max(1, (4 << 20) // max(1, nB))
    part_keys, part_accs = [], []
    for a0 in range(0, nA, chunk):
        a1 = min(nA, a0 + chunk)
        na = a1 - a0
        ia = np.repeat(np.arange(a0, a1), nB)
        ib = np.tile(np.arange(nB), na)
        pair_lid = (A.layer_id[ia].astype(np.int64) * LB
                    + B.layer_id[ib].astype(np.int64))
        idx_sum = (A.idx[ia].astype(np.int64) + B.idx[ib].astype(np.int64)) % Bmod
        diff_sign = (A.ch[ia] != B.ch[ib])
        key = (pair_lid * Bmod + idx_sum) * 2 + diff_sign.astype(np.int64)
        ww = FV.mul(A.w[ia], B.w[ib]).astype(np.uint64)  # [pairs, 4]
        del ia, ib, pair_lid, idx_sum, diff_sign
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.zeros((len(uniq), 4), dtype=np.uint64)
        np.add.at(acc, inv, ww)
        # per-bucket addends < 2^32 and limbs < 2^32 -> u64 never overflows
        part_keys.append(uniq)
        part_accs.append(acc)
    all_keys = np.concatenate(part_keys) if part_keys else np.zeros(0, np.int64)
    all_accs = (np.concatenate(part_accs)
                if part_accs else np.zeros((0, 4), np.uint64))
    uniq, inv = np.unique(all_keys, return_inverse=True)
    acc = np.zeros((len(uniq), 4), dtype=np.uint64)
    np.add.at(acc, inv, all_accs)

    from .. import native

    red = native.reduce_u64_limbs(acc)
    if red is None:
        red = (FV.canon_u64_limbs(acc) if len(uniq)
               else np.zeros((0, 4), dtype=U32))
    nz = red.any(axis=1)
    ks = uniq[nz]
    out_lid = (base + (ks // 2) // Bmod).astype(np.int32)
    out_idx = ((ks // 2) % Bmod).astype(np.int32)
    out_ch = np.where((ks & 1) == 0, SGN_P, SGN_M).astype(np.int8)
    out_w = red[nz]
    return _stage_dict(layers, base, out_lid, out_idx, out_ch, out_w)


def ct_mul(pk: PubKey, A: Cipher, B: Cipher) -> Cipher:
    """Edge cross product with PROD layer grid (arithmetic.hpp:47-106)."""
    return ct_mul_batch(pk, [(A, B)])[0]
