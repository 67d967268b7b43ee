"""Encryption (reference: include/pvac/ops/encrypt.hpp).

Single-ciphertext calls mirror the reference API; internally everything is
batched — one prf_cores_batch call covers all (layer, domain, noise-group)
PRF evaluations and one sigma_words call covers all edges, so encrypting a
batch of values costs one pass through the vectorized AES/SHA engines.

Host randomness (nonces, index picks, random weights) comes from the OS
CSPRNG exactly like the reference (encrypt.hpp:131-160); since those draws
are random the two implementations produce differently-random but
identically-distributed ciphertexts, which the reverse-interop test
(reference decodes our .ct files) verifies.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import dbg
from ..core import bitvec as BV
from ..core import field as F
from ..core import fieldv as FV
from ..core.random import csprng_u64, csprng_u64_array
from ..crypto import lpn, matrix
from ..types import (
    Cipher, Dom, Layer, LazySigma, Nonce128, PubKey, RSeed, SecKey,
    RRULE_BASE, RRULE_PROD, SGN_P, SGN_M, make_nonce128, sgn_val,
)

U32 = np.uint32
U64MAX = (1 << 64) - 1


def plan_noise(pk: PubKey, depth_hint: int) -> tuple[int, int]:
    """Noise-group budgeting (encrypt.hpp:16-27)."""
    prm = pk.prm
    budget = prm.noise_entropy_bits + prm.depth_slope_bits * max(0, depth_hint)
    per2 = 2.0 * math.log2(float(prm.B))
    per3 = 3.0 * math.log2(float(prm.B))
    z2 = max(0, int(math.floor((budget * prm.tuple2_fraction) / max(1e-6, per2))))
    z3 = max(0, int(math.floor((budget * (1.0 - prm.tuple2_fraction)) / max(1e-6, per3))))
    if z2 + z3 == 1:
        if z3 > 0:
            z3 += 1
        else:
            z2 += 1
    return z2, z3


def sigma_density(pk: PubKey, C: Cipher) -> float:
    """Mean σ bit density (encrypt.hpp:29-37)."""
    if C.n_edges == 0:
        return 0.0
    from ..types import VirtualSigma

    if isinstance(C.sigma, VirtualSigma):
        ones = C.sigma.popcnt_total()  # streamed, never holds full σ
    else:
        ones = int(BV.popcnt(np.asarray(C.sigma)).sum())
    return ones / float(C.n_edges * pk.prm.m_bits)


def _concat_sigma(a, b):
    """Concatenate two σ matrices, staying lazy/virtual/on-device when
    possible (np.concatenate on a device operand would silently fetch it)."""
    from ..types import StackedSigma, VirtualSigma, concat_virtual_sigma

    if (isinstance(a, LazySigma) and isinstance(b, LazySigma)
            and a.base is b.base and a.fixup is b.fixup):
        return LazySigma(a.base, np.concatenate([a.rows, b.rows]), a.fixup)
    if isinstance(a, VirtualSigma) and isinstance(b, VirtualSigma):
        return concat_virtual_sigma([a, b])
    if isinstance(a, (StackedSigma, np.ndarray)) and isinstance(
            b, (StackedSigma, np.ndarray)) and (
            isinstance(a, StackedSigma) or isinstance(b, StackedSigma)):
        pa = a.parts if isinstance(a, StackedSigma) else [a]
        pb = b.parts if isinstance(b, StackedSigma) else [b]
        return StackedSigma(pa + pb)
    return np.concatenate([np.asarray(a), np.asarray(b)])


def _weights_to_ints(w: np.ndarray) -> list[int]:
    return FV.to_ints(w)


def compact_edges(pk: PubKey, C: Cipher) -> None:
    """Aggregate edges by (layer, idx, sign): weights sum in F_p, syndromes
    XOR (encrypt.hpp:39-71).  Emission order matches the reference: layer
    ascending, idx ascending, P before M."""
    E = C.n_edges
    if E == 0:
        return
    B = pk.prm.B
    key = (
        C.layer_id.astype(np.int64) * (2 * B)
        + C.idx.astype(np.int64) * 2
        + C.ch.astype(np.int64)
    )
    order = np.argsort(key, kind="stable")
    skey = key[order]
    uniq, start = np.unique(skey, return_index=True)
    from ..types import VirtualSigma

    if isinstance(C.sigma, VirtualSigma) and len(uniq) == E:
        # Every bucket is a single edge (the usual case for deep products,
        # whose edges are aggregation outputs and already unique): the
        # compaction is a pure reorder, so σ stays virtual.  The reference's
        # (w == 0 and σ == 0) bucket drop (encrypt.hpp:60-63) is skipped for
        # virtual rows — a fresh pseudorandom σ is zero with probability
        # 2^-m_bits, so the behaviors agree outside measure-zero events.
        C.layer_id = C.layer_id[order]
        C.idx = C.idx[order]
        C.ch = C.ch[order]
        C.w = C.w[order]
        C.sigma = C.sigma[order]
        return
    C.sigma = np.asarray(C.sigma)  # materialize device-resident σ
    # per-bucket field sum: limb-wise uint64 accumulation then mod p
    wl = C.w[order].astype(np.uint64)
    seg = np.zeros(E, dtype=np.int64)
    seg[start] = 1
    seg = np.cumsum(seg) - 1  # bucket id per sorted edge
    nb = len(uniq)
    acc = np.zeros((nb, 4), dtype=np.uint64)
    np.add.at(acc, seg, wl)
    sig = np.zeros((nb, C.sigma.shape[1]), dtype=U32)
    np.bitwise_xor.at(sig, seg, C.sigma[order])

    from .. import native

    red = native.reduce_u64_limbs(acc)
    if red is None:
        red = FV.canon_u64_limbs(acc)
    # drop buckets whose weight sum AND σ are both zero (encrypt.hpp:60-63)
    keep = red.any(axis=1) | sig.any(axis=1)
    k = uniq[keep]
    C.layer_id = (k // (2 * B)).astype(np.int32)
    C.idx = ((k // 2) % B).astype(np.int32)
    C.ch = (k & 1).astype(np.int8)
    C.w = red[keep]
    C.sigma = sig[keep]


def compact_layers(C: Cipher) -> None:
    """Drop unreferenced layers, keeping PROD parents live (encrypt.hpp:73-104).

    Vectorized: liveness propagates to PROD parents as array gathers (the
    fixpoint runs once per DAG level), and the remap is one cumulative-sum
    pass — O(L * depth) instead of the reference's O(L^2) scan, which
    matters at deep-product scale (a depth-4 square has ~66k layers)."""
    L = C.n_layers
    if L == 0:
        return
    lids = np.unique(C.layer_id)
    if lids.size == L and lids[0] == 0 and lids[-1] == L - 1:
        # sorted unique ids covering exactly 0..L-1: every layer is directly
        # referenced by an edge, so the GC below is a no-op — skip it.  This
        # is the common case (every op producer compacts before returning),
        # and it makes ct_add's mandatory compact_layers call (reference
        # arithmetic.hpp:29) nearly free.
        return
    used = np.zeros(L, dtype=bool)
    used[lids[lids < L]] = True
    rules = np.fromiter((Lr.rule for Lr in C.layers), dtype=np.int8, count=L)
    pa = np.fromiter((Lr.pa for Lr in C.layers), dtype=np.int64, count=L)
    pb = np.fromiter((Lr.pb for Lr in C.layers), dtype=np.int64, count=L)
    is_prod = rules == RRULE_PROD
    while True:
        live_prod = used & is_prod
        parents = np.concatenate([pa[live_prod], pb[live_prod]])
        parents = parents[parents < L]
        newly = ~used[parents]
        if not newly.any():
            break
        used[parents[newly]] = True
    if used.all():
        return
    remap = np.cumsum(used) - 1  # new id per old id (valid where used)
    new_layers = [C.layers[i] for i in np.nonzero(used)[0]]
    for Lr in new_layers:
        if Lr.rule == RRULE_PROD:
            Lr.pa = int(remap[Lr.pa])
            Lr.pb = int(remap[Lr.pb])
    C.layers = new_layers
    C.layer_id = remap[C.layer_id].astype(np.int32)


def guard_budget(pk: PubKey, C: Cipher, where: str) -> None:
    """Force compaction past the edge budget (encrypt.hpp:106-111)."""
    if C.n_edges > pk.prm.edge_budget:
        dbg(1, f"[guard] {where}: {C.n_edges} -> compact")
        compact_edges(pk, C)


def prf_noise_delta_seed(base: RSeed, group_id: int, kind: int) -> RSeed:
    """Seed tweak for noise deltas (encrypt.hpp:114-129)."""
    g = (group_id + 1) & U64MAX
    k = (kind + 1) & U64MAX
    lo = base.nonce.lo ^ ((0x9E3779B97F4A7C15 * g) & U64MAX)
    hi = base.nonce.hi ^ ((0x94D049BB133111EB * g) & U64MAX)
    zt = base.ztag ^ ((0x517CC1B727220A95 * g) & U64MAX)
    lo ^= k
    hi ^= (k << 32) & U64MAX
    zt ^= (k << 48) & U64MAX
    return RSeed(ztag=zt, nonce=Nonce128(lo, hi))


def prf_noise_delta(pk: PubKey, sk: SecKey, base_seed: RSeed, group_id: int,
                    kind: int) -> int:
    return lpn.prf_R_noise(pk, sk, prf_noise_delta_seed(base_seed, group_id, kind))


def _pick_unique_idx(B: int, used: set) -> int:
    while True:
        x = csprng_u64() % B
        if x not in used:
            used.add(x)
            return x


def _pick_distinct(B: int, *exclude) -> int:
    while True:
        x = csprng_u64() % B
        if x not in exclude:
            return x


class _LayerPlan:
    """Host-side plan of one fresh BASE layer: all randomness and index
    choices drawn, PRF requests collected for batching."""

    __slots__ = ("seed", "value", "edges", "n_delta", "z2", "z3",
                 "vstruct", "z2g", "z3g", "arrs",
                 "skel_idx", "skel_ch", "skel_inv")

    def __init__(self, pk: PubKey, value: int, depth_hint: int):
        nonce = make_nonce128()
        self.seed = RSeed(
            ztag=matrix.prg_layer_ztag(pk.canon_tag, nonce), nonce=nonce
        )
        self.value = value
        self.z2, self.z3 = plan_noise(pk, depth_hint)
        self.n_delta = max(0, self.z2 + self.z3 - 1)
        self.edges = None  # filled after PRF resolution


def _prf_requests(plan: _LayerPlan) -> list[tuple[RSeed, str]]:
    reqs = []
    for d in (Dom.PRF_R1, Dom.PRF_R2, Dom.PRF_R3):
        reqs.append((plan.seed, d))
    total = plan.z2 + plan.z3
    for g in range(total):
        if total - g <= 1:
            break
        kind = 0 if g < plan.z2 else 1
        s2 = prf_noise_delta_seed(plan.seed, g, kind)
        for d in (Dom.PRF_NOISE1, Dom.PRF_NOISE2, Dom.PRF_NOISE3):
            reqs.append((s2, d))
    return reqs


def _draw_structure(pk: PubKey, plan: _LayerPlan) -> None:
    """Draw everything PRF-independent for one layer: edge indices, signs
    and the free random weights (the CSPRNG draw order exactly mirrors the
    single-pass encryptor, encrypt.hpp:162-252).  Fills plan.vstruct /
    plan.z2g / plan.z3g and the (idx, ch) edge skeleton, so σ generation can
    be dispatched before the PRF results arrive."""
    B = pk.prm.B
    S = 8
    used: set = set()
    idxs = [_pick_unique_idx(B, used) for _ in range(S)]
    chs = [csprng_u64() & 1 for _ in range(S)]
    rs = [F.rand_fp_nonzero() for _ in range(S - 1)]
    plan.vstruct = (idxs, chs, rs)
    plan.arrs = None  # scalar path keeps the tuple (oracle) representation
    skel = [(idxs[j], chs[j]) for j in range(S)]

    plan.z2g = []
    for _ in range(plan.z2):
        i = csprng_u64() % B
        j = _pick_distinct(B, i)
        s1 = csprng_u64() & 1
        s2 = s1 ^ 1
        r_i = F.rand_fp_nonzero()
        plan.z2g.append((i, j, s1, s2, r_i))
        skel.append((i, s1))
        skel.append((j, s2))

    plan.z3g = []
    for _ in range(plan.z3):
        i = csprng_u64() % B
        j = _pick_distinct(B, i)
        k = _pick_distinct(B, i, j)
        s1, s2, s3 = csprng_u64() & 1, csprng_u64() & 1, csprng_u64() & 1
        a = F.rand_fp_nonzero()
        b = F.rand_fp_nonzero()
        plan.z3g.append((i, j, k, s1, s2, s3, a, b))
        skel.append((i, s1))
        skel.append((j, s2))
        skel.append((k, s3))

    # Pre-aggregate duplicate (idx, ch) pairs: weights of merged edges sum
    # later; σ is generated once per merged edge (equivalent to the
    # reference's post-hoc compact_edges, encrypt.hpp:39-71, since merged σ
    # is fresh uniform camouflage either way).
    key = np.asarray([i * 2 + c for (i, c) in skel], dtype=np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    plan.skel_idx = (uniq // 2).astype(np.int32)
    plan.skel_ch = (uniq & 1).astype(np.int8)
    plan.skel_inv = inv.astype(np.int64)


def _rand_fp_nonzero_rows(m: int) -> np.ndarray:
    """m uniform nonzero field elements as [m, 4] uint32 limb rows, drawn
    and packed fully vectorized (no Python bigints — building ints from
    the numpy draws and converting them back to limbs cost ~30 ms per
    warm 512-value batch).  Same per-element distribution as
    F.rand_fp_nonzero (core/types.hpp:145-155): x = hi<<64 | lo with
    hi < 2^63, rejecting 0 and P."""
    out = np.empty((m, 4), dtype=U32)
    pending = np.arange(m)
    M32 = np.uint64(0xFFFFFFFF)
    while pending.size:
        k = pending.size
        lo = csprng_u64_array(k)
        hi = csprng_u64_array(k) & np.uint64((1 << 63) - 1)
        bad = ((lo == 0) & (hi == 0)) | (
            (lo == np.uint64(0xFFFFFFFFFFFFFFFF))
            & (hi == np.uint64((1 << 63) - 1))
        )
        out[pending, 0] = (lo & M32).astype(U32)
        out[pending, 1] = (lo >> np.uint64(32)).astype(U32)
        out[pending, 2] = (hi & M32).astype(U32)
        out[pending, 3] = (hi >> np.uint64(32)).astype(U32)
        pending = pending[bad]
    return out


def _rand_fp_nonzero_batch(m: int) -> list[int]:
    """m uniform nonzero field elements as Python ints (scalar-oracle
    form of _rand_fp_nonzero_rows)."""
    return FV.to_ints(_rand_fp_nonzero_rows(m))


def _mod_draws(m: int, B: int) -> np.ndarray:
    return (csprng_u64_array(m) % np.uint64(B)).astype(np.int64)


def _draw_structures_batch(pk: PubKey, plans: list[_LayerPlan]) -> None:
    """Vectorized _draw_structure over a whole plan batch: all CSPRNG
    material arrives in bulk getrandom calls and the index/sign/weight
    pools are computed with numpy, so the per-layer python work is just
    slicing.  Statistically identical to the scalar path (which remains
    the documented oracle); the scheme never depends on draw ORDER, only
    on each draw's distribution (OS CSPRNG, reference encrypt.hpp:131-160).
    """
    B = pk.prm.B
    S = 8
    groups: dict[tuple[int, int], list[int]] = {}
    for t, p in enumerate(plans):
        groups.setdefault((p.z2, p.z3), []).append(t)

    for (z2, z3), ids in groups.items():
        n = len(ids)
        # --- 8 unique value-edge indices per plan: first-S-unique of a
        # 16-draw window, redrawing the (rare) rows that fall short ---
        D = 16
        vidx = np.empty((n, S), dtype=np.int64)
        pending = np.arange(n)
        earlier = np.tril(np.ones((D, D), dtype=bool), k=-1)
        while pending.size:
            m = pending.size
            draws = _mod_draws(m * D, B).reshape(m, D)
            dup = (draws[:, :, None] == draws[:, None, :]) & earlier[None]
            first = ~dup.any(-1)
            rank = np.cumsum(first, axis=1)
            ok = rank[:, -1] >= S
            take = first & (rank <= S)
            if ok.any():
                vidx[pending[ok]] = draws[ok][take[ok]].reshape(-1, S)
            pending = pending[~ok]
        vch = (csprng_u64_array(n * S) & np.uint64(1)).astype(np.int64) \
            .reshape(n, S)
        vrs = _rand_fp_nonzero_rows(n * (S - 1)).reshape(n, S - 1, 4)

        # --- z2 pairs: i free, j != i ---
        if z2:
            i2 = _mod_draws(n * z2, B).reshape(n, z2)
            j2 = _mod_draws(n * z2, B).reshape(n, z2)
            bad = j2 == i2
            while bad.any():
                j2[bad] = _mod_draws(int(bad.sum()), B)
                bad = j2 == i2
            s2a = (csprng_u64_array(n * z2) & np.uint64(1)).astype(np.int64) \
                .reshape(n, z2)
            r2 = _rand_fp_nonzero_rows(n * z2).reshape(n, z2, 4)
        # --- z3 triples: i free, j != i, k not in {i, j} ---
        if z3:
            i3 = _mod_draws(n * z3, B).reshape(n, z3)
            j3 = _mod_draws(n * z3, B).reshape(n, z3)
            bad = j3 == i3
            while bad.any():
                j3[bad] = _mod_draws(int(bad.sum()), B)
                bad = j3 == i3
            k3 = _mod_draws(n * z3, B).reshape(n, z3)
            bad = (k3 == i3) | (k3 == j3)
            while bad.any():
                k3[bad] = _mod_draws(int(bad.sum()), B)
                bad = (k3 == i3) | (k3 == j3)
            s3a = (csprng_u64_array(3 * n * z3) & np.uint64(1)) \
                .astype(np.int64).reshape(n, z3, 3)
            ab3 = _rand_fp_nonzero_rows(2 * n * z3).reshape(n, z3, 2, 4)

        # --- vectorized (idx, ch) skeleton + duplicate merge across the
        # whole group: per-plan np.unique was ~17 ms/1024 plans of pure
        # call overhead; one global unique with plan-offset keys is ~1 ms
        # and yields identical per-plan (sorted) merge tables ---
        cols_i = [vidx]
        cols_c = [vch]
        if z2:
            cols_i.append(np.stack([i2, j2], axis=2).reshape(n, 2 * z2))
            cols_c.append(np.stack([s2a, s2a ^ 1], axis=2).reshape(n, 2 * z2))
        if z3:
            cols_i.append(np.stack([i3, j3, k3], axis=2).reshape(n, 3 * z3))
            cols_c.append(s3a.reshape(n, 3 * z3))
        skel_i_all = np.concatenate(cols_i, axis=1)  # [n, E]
        skel_c_all = np.concatenate(cols_c, axis=1)
        Epp = skel_i_all.shape[1]
        span = 2 * B
        gkey = (skel_i_all * 2 + skel_c_all
                + (np.arange(n, dtype=np.int64) * span)[:, None])
        uniq, inv = np.unique(gkey.reshape(-1), return_inverse=True)
        owner_starts = np.searchsorted(uniq // span, np.arange(n + 1))
        inv2 = inv.reshape(n, Epp)

        for s, t in enumerate(ids):
            plan = plans[t]
            # tuple forms stay unset on the vectorized path; the weights
            # stage reads plan.arrs (the scalar oracle _draw_structure
            # still fills tuples, and the weights batch falls back to
            # them when arrs is None)
            plan.vstruct = None
            plan.z2g = None
            plan.z3g = None
            plan.arrs = {
                "vidx": vidx[s], "vch": vch[s], "vrs": vrs[s],
                "i2": i2[s] if z2 else None,
                "j2": j2[s] if z2 else None,
                "s2a": s2a[s] if z2 else None,
                "r2": r2[s] if z2 else None,
                "i3": i3[s] if z3 else None,
                "j3": j3[s] if z3 else None,
                "k3": k3[s] if z3 else None,
                "s3a": s3a[s] if z3 else None,
                "ab3": ab3[s] if z3 else None,
            }
            lo_, hi_ = owner_starts[s], owner_starts[s + 1]
            u = uniq[lo_:hi_] - s * span
            plan.skel_idx = (u // 2).astype(np.int32)
            plan.skel_ch = (u & 1).astype(np.int8)
            plan.skel_inv = (inv2[s] - lo_).astype(np.int64)


def _weights_from_cores(pk: PubKey, plan: _LayerPlan, cores: list[int]) -> list[int]:
    """Scalar reference for _weights_from_cores_batch (kept as the test
    oracle): given one layer's resolved PRF cores (request order), compute
    the merged-edge weights for the drawn structure (encrypt.hpp:162-252)."""
    R = F.fp_mul(F.fp_mul(cores[0], cores[1]), cores[2])
    deltas = []
    for i in range(3, len(cores), 3):
        deltas.append(F.fp_mul(F.fp_mul(cores[i], cores[i + 1]), cores[i + 2]))

    ws = []
    S = 8
    idxs, chs, rs_free = plan.vstruct
    sumg = 0
    rs = []
    for j in range(S - 1):
        r = rs_free[j]
        rs.append(r)
        term = F.fp_mul(r, pk.powg_B[idxs[j]])
        sumg = F.fp_add(sumg, term) if sgn_val(chs[j]) > 0 else F.fp_sub(sumg, term)
    g_last = pk.powg_B[idxs[S - 1]]
    r_last = F.fp_mul(F.fp_sub(plan.value, sumg), F.fp_inv(g_last))
    rs.append(F.fp_neg(r_last) if sgn_val(chs[S - 1]) < 0 else r_last)
    for j in range(S):
        ws.append(F.fp_mul(rs[j], R))

    total = plan.z2 + plan.z3
    delta_acc = 0
    di = 0
    group_id = 0

    def next_delta() -> int:
        nonlocal delta_acc, di
        if total - group_id <= 1:
            return F.fp_neg(delta_acc)
        d = deltas[di]
        di += 1
        delta_acc = F.fp_add(delta_acc, d)
        return d

    for (i, j, s1, s2, r_i) in plan.z2g:
        Delta = next_delta()
        group_id += 1
        Dp = Delta if sgn_val(s1) > 0 else F.fp_neg(Delta)
        gi, gj = pk.powg_B[i], pk.powg_B[j]
        r_j = F.fp_mul(F.fp_sub(F.fp_mul(r_i, gi), Dp), F.fp_inv(gj))
        ws.append(F.fp_mul(r_i, R))
        ws.append(F.fp_mul(r_j, R))

    for (i, j, k, s1, s2, s3, a, b) in plan.z3g:
        Delta = next_delta()
        group_id += 1
        t1 = F.fp_mul(a, pk.powg_B[i])
        t2 = F.fp_mul(b, pk.powg_B[j])
        if sgn_val(s1) < 0:
            t1 = F.fp_neg(t1)
        if sgn_val(s2) < 0:
            t2 = F.fp_neg(t2)
        gk = pk.powg_B[k] if sgn_val(s3) > 0 else F.fp_neg(pk.powg_B[k])
        c = F.fp_mul(F.fp_sub(Delta, F.fp_add(t1, t2)), F.fp_inv(gk))
        ws.append(F.fp_mul(a, R))
        ws.append(F.fp_mul(b, R))
        ws.append(F.fp_mul(c, R))

    # fold duplicate (idx, ch) edges: field-sum of member weights
    merged = [0] * len(plan.skel_idx)
    for pos, g in enumerate(plan.skel_inv):
        merged[g] = F.fp_add(merged[g], ws[pos])
    return merged


def _weights_from_cores_batch(pk: PubKey, plans: list[_LayerPlan],
                              cores: np.ndarray,
                              spans: list[tuple[int, int]]) -> list[np.ndarray]:
    """Vectorized _weights_from_cores over a whole plan batch.

    cores is the [N_req, 4]-limb PRF result array (request order matching
    spans); returns one [n_merged, 4] uint32 weight array per plan.  All
    field math runs as fieldv limb vectors; the per-group fp_inv calls of
    the scalar path become powg table lookups, since g has order B:
    inv(g^i) = g^((B-i) mod B).  Plans are grouped by (z2, z3) — each group
    vectorizes as one [G, E, 4] computation."""
    cores = np.asarray(cores, dtype=U32)
    Bmod = pk.prm.B
    gp = pk.powg_limbs()  # [B, 4]

    groups: dict[tuple[int, int], list[int]] = {}
    for t, p in enumerate(plans):
        groups.setdefault((p.z2, p.z3), []).append(t)

    out: list[np.ndarray | None] = [None] * len(plans)
    for (z2, z3), ids in groups.items():
        G = len(ids)
        total = z2 + z3
        nd = max(0, total - 1)
        n_req = 3 + 3 * nd
        offs = np.asarray([spans[t][0] for t in ids], dtype=np.int64)
        cg = cores[offs[:, None] + np.arange(n_req)]  # [G, n_req, 4]
        R = FV.mul(FV.mul(cg[:, 0], cg[:, 1]), cg[:, 2])  # [G, 4]
        if nd:
            dd = cg[:, 3:].reshape(G, nd, 3, 4)
            deltas = FV.mul(FV.mul(dd[:, :, 0], dd[:, :, 1]), dd[:, :, 2])

        # ---- value edges (8 per layer) ----
        S = 8
        fast = plans[ids[0]].arrs is not None
        if fast:
            A = [plans[t].arrs for t in ids]
            idxs = np.stack([a["vidx"] for a in A])
            chs = np.stack([a["vch"] for a in A])
            rs_free = np.stack([a["vrs"] for a in A])      # [G, S-1, 4]
        else:
            idxs = np.asarray([plans[t].vstruct[0] for t in ids],
                              dtype=np.int64)
            chs = np.asarray([plans[t].vstruct[1] for t in ids],
                             dtype=np.int64)
            rs_free = FV.from_ints(
                [r for t in ids for r in plans[t].vstruct[2]]
            ).reshape(G, S - 1, 4)
        values = FV.from_ints([plans[t].value for t in ids])  # [G, 4]

        terms = FV.mul(rs_free, gp[idxs[:, : S - 1]])
        signed = FV.select(chs[:, : S - 1] == SGN_P, terms, FV.neg(terms))
        sumg = signed[:, 0]
        for j in range(1, S - 1):
            sumg = FV.add(sumg, signed[:, j])
        r_last = FV.mul(FV.sub(values, sumg), gp[(Bmod - idxs[:, S - 1]) % Bmod])
        r_last = FV.select(chs[:, S - 1] == SGN_P, r_last, FV.neg(r_last))
        parts = [np.concatenate([rs_free, r_last[:, None]], axis=1)]

        # ---- per-group noise deltas: groups 0..total-2 consume deltas in
        # order; the last group closes the telescope with -(sum of them) ----
        if total:
            if nd:
                acc = deltas[:, 0]
                for g in range(1, nd):
                    acc = FV.add(acc, deltas[:, g])
                Delta = np.concatenate(
                    [deltas, FV.neg(acc)[:, None]], axis=1
                )  # [G, total, 4]
            else:  # total == 1 can't occur (plan_noise bumps it), guard anyway
                Delta = np.zeros((G, 1, 4), dtype=U32)

        if z2:
            if fast:
                I2 = np.stack([a["i2"] for a in A])
                J2 = np.stack([a["j2"] for a in A])
                S1 = np.stack([a["s2a"] for a in A])
                ri = np.stack([a["r2"] for a in A])        # [G, z2, 4]
            else:
                z2g = [plans[t].z2g for t in ids]
                I2 = np.asarray([[g[0] for g in row] for row in z2g],
                                dtype=np.int64)
                J2 = np.asarray([[g[1] for g in row] for row in z2g],
                                dtype=np.int64)
                S1 = np.asarray([[g[2] for g in row] for row in z2g],
                                dtype=np.int64)
                ri = FV.from_ints(
                    [g[4] for row in z2g for g in row]
                ).reshape(G, z2, 4)
            D2 = Delta[:, :z2]
            Dp = FV.select(S1 == SGN_P, D2, FV.neg(D2))
            rj = FV.mul(FV.sub(FV.mul(ri, gp[I2]), Dp), gp[(Bmod - J2) % Bmod])
            parts.append(
                np.stack([ri, rj], axis=2).reshape(G, 2 * z2, 4)
            )

        if z3:
            if fast:
                I3 = np.stack([a["i3"] for a in A])
                J3 = np.stack([a["j3"] for a in A])
                K3 = np.stack([a["k3"] for a in A])
                sall = np.stack([a["s3a"] for a in A])     # [G, z3, 3]
                s1, s2, s3 = sall[..., 0], sall[..., 1], sall[..., 2]
                abr = np.stack([a["ab3"] for a in A])      # [G, z3, 2, 4]
                a3, b3 = abr[:, :, 0], abr[:, :, 1]
            else:
                z3g = [plans[t].z3g for t in ids]
                I3 = np.asarray([[g[0] for g in row] for row in z3g],
                                dtype=np.int64)
                J3 = np.asarray([[g[1] for g in row] for row in z3g],
                                dtype=np.int64)
                K3 = np.asarray([[g[2] for g in row] for row in z3g],
                                dtype=np.int64)
                s1 = np.asarray([[g[3] for g in row] for row in z3g],
                                dtype=np.int64)
                s2 = np.asarray([[g[4] for g in row] for row in z3g],
                                dtype=np.int64)
                s3 = np.asarray([[g[5] for g in row] for row in z3g],
                                dtype=np.int64)
                a3 = FV.from_ints(
                    [g[6] for row in z3g for g in row]).reshape(G, z3, 4)
                b3 = FV.from_ints(
                    [g[7] for row in z3g for g in row]).reshape(G, z3, 4)
            t1 = FV.mul(a3, gp[I3])
            t1 = FV.select(s1 == SGN_P, t1, FV.neg(t1))
            t2 = FV.mul(b3, gp[J3])
            t2 = FV.select(s2 == SGN_P, t2, FV.neg(t2))
            c3 = FV.mul(
                FV.sub(Delta[:, z2:], FV.add(t1, t2)), gp[(Bmod - K3) % Bmod]
            )
            c3 = FV.select(s3 == SGN_P, c3, FV.neg(c3))
            parts.append(np.stack([a3, b3, c3], axis=2).reshape(G, 3 * z3, 4))

        ws = FV.mul(np.concatenate(parts, axis=1), R[:, None])  # [G, E, 4]
        E = ws.shape[1]

        # ---- ragged merge by each plan's (idx, ch)-duplicate groups ----
        counts = [len(plans[t].skel_idx) for t in ids]
        starts = np.concatenate([[0], np.cumsum(counts)])
        glob_inv = np.concatenate(
            [plans[t].skel_inv + starts[s] for s, t in enumerate(ids)]
        )
        acc = np.zeros((int(starts[-1]), 4), dtype=np.uint64)
        np.add.at(acc, glob_inv, ws.reshape(G * E, 4).astype(np.uint64))
        from .. import native

        red = native.reduce_u64_limbs(acc)
        if red is None:
            red = FV.canon_u64_limbs(acc)
        for s, t in enumerate(ids):
            out[t] = red[starts[s] : starts[s + 1]]
    return out


def _sigma_for_plans_start(pk: PubKey, plans: list[_LayerPlan]):
    """Dispatch one σ batch covering every (merged) skeleton edge of every
    planned layer.  Returns finalize() -> (sig_all, offsets); sig_all stays
    device-resident on the engine path."""
    idxs, chs, zt, nlo, nhi = [], [], [], [], []
    offsets = [0]
    for plan in plans:
        idxs.append(plan.skel_idx)
        chs.append(plan.skel_ch)
        n = len(plan.skel_idx)
        zt.append(np.full(n, plan.seed.ztag, dtype=np.uint64))
        nlo.append(np.full(n, plan.seed.nonce.lo, dtype=np.uint64))
        nhi.append(np.full(n, plan.seed.nonce.hi, dtype=np.uint64))
        offsets.append(offsets[-1] + n)
    idxs = np.concatenate(idxs).astype(np.uint64)
    chs = np.concatenate(chs).astype(np.uint64)
    salts = csprng_u64_array(len(idxs))
    ltab = np.array(
        [[p.seed.ztag, p.seed.nonce.lo, p.seed.nonce.hi] for p in plans],
        dtype=np.uint64,
    ).reshape(len(plans), 3)
    lid = np.repeat(np.arange(len(plans)),
                    np.diff(np.asarray(offsets)))
    fin = matrix.sigma_words_start(
        pk,
        np.concatenate(zt), np.concatenate(nlo), np.concatenate(nhi),
        idxs, chs, np.asarray(salts, dtype=np.uint64),
        tab=(ltab, lid),
    )

    def finalize():
        if not isinstance(fin.sig, np.ndarray):
            # device σ: skip the fallback-flag fetch (a host sync); the
            # LazySigma fixup patches the rare fallback lanes
            # lazily on first materialization
            parts, fixer, vrows = matrix.sigma_deferred([fin])
            return parts[0], offsets, fixer, vrows
        return fin(), offsets, None, None

    return finalize


def _build_cipher_from_plan(pk: PubKey, plan: _LayerPlan, weights: np.ndarray,
                            sig) -> Cipher:
    """Assemble one single-BASE-layer Cipher from a drawn structure, its
    merged [n, 4]-limb weights and its pre-generated σ rows."""
    n = len(plan.skel_idx)
    return Cipher(
        [Layer(rule=RRULE_BASE, seed=plan.seed)],
        np.zeros(n, dtype=np.int32),
        plan.skel_idx,
        plan.skel_ch,
        np.asarray(weights, dtype=U32),
        sig,
    )


def _apply_perm(C: Cipher, perm: np.ndarray) -> None:
    C.layer_id = C.layer_id[perm]
    C.idx = C.idx[perm]
    C.ch = C.ch[perm]
    C.w = C.w[perm]
    C.sigma = C.sigma[perm]


def _shuffle_edges(C: Cipher, keys: np.ndarray | None = None) -> None:
    """Uniform random edge shuffle (reference: Fisher-Yates,
    encrypt.hpp:155-160).  Order is camouflage only — the scheme depends on
    each edge's distribution, never on table order — so argsort of uniform
    u64 CSPRNG keys (a uniform permutation up to measure-zero key ties)
    replaces the python-loop Fisher-Yates; ``keys`` lets a batch caller
    draw one CSPRNG block for all its ciphertexts."""
    n = C.n_edges
    if n < 2:
        return
    if keys is None:
        keys = csprng_u64_array(n)
    _apply_perm(C, np.argsort(keys, kind="stable"))


def enc_fp_depth_batch(pk: PubKey, sk: SecKey, values: list[int],
                       depth_hints: list[int]) -> list[Cipher]:
    """Batch of single-layer encryptions — one PRF batch + one σ batch.

    The PRF and σ device programs are dispatched back-to-back before either
    result is fetched, and the host computes weights while σ generation is
    still in flight: over a high-latency device link the two fetches are the
    only synchronization points.  Duplicate (idx, ch) edges are merged
    *before* σ generation (same output shape as the reference's post-hoc
    compact_edges, encrypt.hpp:39-71), and σ stays device-resident until a
    consumer needs host bytes.
    """
    return enc_fp_depth_batch_start(pk, sk, values, depth_hints)()


def enc_fp_depth_batch_start(pk: PubKey, sk: SecKey, values: list[int],
                             depth_hints: list[int], pair_shares: bool = False):
    """Dispatch half of enc_fp_depth_batch: PRF + σ device programs are
    in flight when this returns; the returned finalize() fetches the cores,
    computes weights and assembles the Ciphers.  A caller encrypting many
    chunks overlaps chunk i's host finalize with chunk i+1's device work
    (see enc_value_batch's internal pipeline).

    With pair_shares=True consecutive plans (2i, 2i+1) assemble directly
    into one two-BASE-layer Cipher — the fused equivalent of per-share
    Ciphers + combine_ciphers (encrypt.hpp:260-279), skipping the
    intermediate objects and per-share guard/compact passes."""
    plans = [_LayerPlan(pk, v, d) for v, d in zip(values, depth_hints)]
    reqs = []
    spans = []
    for p in plans:
        r = _prf_requests(p)
        spans.append((len(reqs), len(r)))
        reqs.extend(r)
    seeds = np.array(
        [[s.ztag, s.nonce.lo, s.nonce.hi] for s, _ in reqs], dtype=np.uint64
    )
    dh = np.array([lpn.DOM_HASH[d] for _, d in reqs], dtype=np.uint64)
    prf_fin = lpn.prf_cores_batch_start(pk, sk, seeds, dh)
    _draw_structures_batch(pk, plans)
    sig_fin = _sigma_for_plans_start(pk, plans)

    def finalize() -> list[Cipher]:
        cores = np.asarray(prf_fin(), dtype=U32)
        weights = _weights_from_cores_batch(pk, plans, cores, spans)
        sig_all, offsets, fixer, vrows = sig_fin()
        if isinstance(sig_all, np.ndarray):
            views = [
                sig_all[offsets[i] : offsets[i + 1]]
                for i in range(len(plans))
            ]
        else:
            views = [
                LazySigma(sig_all, vrows[offsets[i] : offsets[i + 1]], fixer)
                for i in range(len(plans))
            ]
        # one CSPRNG block covers every ciphertext's shuffle keys
        nks = [len(p.skel_idx) for p in plans]
        kstarts = np.zeros(len(plans) + 1, dtype=np.int64)
        np.cumsum(nks, out=kstarts[1:])
        all_keys = csprng_u64_array(int(kstarts[-1]))
        out = []
        if pair_shares:
            for i in range(0, len(plans), 2):
                pa, pb = plans[i], plans[i + 1]
                na, nb = nks[i], nks[i + 1]
                perm_a = np.argsort(all_keys[kstarts[i] : kstarts[i] + na],
                                    kind="stable")
                perm_b = np.argsort(all_keys[kstarts[i + 1] : kstarts[i + 1] + nb],
                                    kind="stable")
                lid = np.zeros(na + nb, dtype=np.int32)
                lid[na:] = 1
                C = Cipher(
                    [Layer(rule=RRULE_BASE, seed=pa.seed),
                     Layer(rule=RRULE_BASE, seed=pb.seed)],
                    lid,
                    np.concatenate([pa.skel_idx[perm_a],
                                    pb.skel_idx[perm_b]]),
                    np.concatenate([pa.skel_ch[perm_a], pb.skel_ch[perm_b]]),
                    np.concatenate([np.asarray(weights[i], dtype=U32)[perm_a],
                                    np.asarray(weights[i + 1],
                                               dtype=U32)[perm_b]]),
                    _concat_sigma(views[i][perm_a], views[i + 1][perm_b]),
                )
                guard_budget(pk, C, "enc")
                out.append(C)
            return out
        for i, (p, ws, sig) in enumerate(zip(plans, weights, views)):
            C = _build_cipher_from_plan(pk, p, ws, sig)
            guard_budget(pk, C, "enc")
            _shuffle_edges(C, all_keys[kstarts[i] : kstarts[i + 1]])
            out.append(C)
        return out

    return finalize


def enc_fp_depth(pk: PubKey, sk: SecKey, v: int, depth_hint: int) -> Cipher:
    """enc_fp_depth (encrypt.hpp:162-258)."""
    return enc_fp_depth_batch(pk, sk, [v], [depth_hint])[0]


def combine_ciphers(pk: PubKey, a: Cipher, b: Cipher) -> Cipher:
    """Concatenate layers + edges with layer-id offsetting (encrypt.hpp:260-279)."""
    off = a.n_layers
    layers = [Layer(L.rule, L.seed, L.pa, L.pb) for L in a.layers]
    for L in b.layers:
        if L.rule == RRULE_PROD:
            layers.append(Layer(L.rule, L.seed, L.pa + off, L.pb + off))
        else:
            layers.append(Layer(L.rule, L.seed, L.pa, L.pb))
    C = Cipher(
        layers,
        np.concatenate([a.layer_id, b.layer_id + np.int32(off)]),
        np.concatenate([a.idx, b.idx]),
        np.concatenate([a.ch, b.ch]),
        np.concatenate([a.w, b.w]),
        _concat_sigma(a.sigma, b.sigma),
    )
    guard_budget(pk, C, "combine")
    compact_layers(C)
    return C


def enc_value_depth(pk: PubKey, sk: SecKey, v: int, depth_hint: int) -> Cipher:
    """Two-share split v = (v+mask) + (-mask) (encrypt.hpp:281-287)."""
    val = F.fp_from_u64(v)
    mask = F.rand_fp_nonzero()
    c1, c2 = enc_fp_depth_batch(
        pk, sk, [F.fp_add(val, mask), F.fp_neg(mask)], [depth_hint, depth_hint]
    )
    return combine_ciphers(pk, c1, c2)


def enc_value(pk: PubKey, sk: SecKey, v: int) -> Cipher:
    return enc_value_depth(pk, sk, v, 0)


def enc_zero_depth(pk: PubKey, sk: SecKey, depth_hint: int) -> Cipher:
    mask = F.rand_fp_nonzero()
    c1, c2 = enc_fp_depth_batch(
        pk, sk, [mask, F.fp_neg(mask)], [depth_hint, depth_hint]
    )
    return combine_ciphers(pk, c1, c2)


def enc_value_batch(pk: PubKey, sk: SecKey, values: list[int],
                    depth_hint: int = 0,
                    pipeline_chunk: int = 1024) -> list[Cipher]:
    """Batched enc_value: all 2N layers share one PRF batch and one σ batch.

    Batches beyond ``pipeline_chunk`` values run software-pipelined: chunk
    i+1's PRF/σ device programs are dispatched BEFORE chunk i's host
    finalize (core fetch + weight math + assembly), so host work and
    device work overlap across the whole run instead of alternating."""
    def shares_of(vs):
        out = []
        for v in vs:
            val = F.fp_from_u64(v)
            mask = F.rand_fp_nonzero()
            out.append(F.fp_add(val, mask))
            out.append(F.fp_neg(mask))
        return out

    n = len(values)
    if n <= pipeline_chunk:
        fin = enc_fp_depth_batch_start(
            pk, sk, shares_of(values), [depth_hint] * (2 * n),
            pair_shares=True)
        return fin()

    out: list[Cipher] = []
    prev = None  # finalize of the previous chunk
    for off in range(0, n, pipeline_chunk):
        vs = values[off : off + pipeline_chunk]
        fin = enc_fp_depth_batch_start(
            pk, sk, shares_of(vs), [depth_hint] * (2 * len(vs)),
            pair_shares=True)
        if prev is not None:
            out.extend(prev())
        prev = fin
    out.extend(prev())
    return out
