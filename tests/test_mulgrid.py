"""Device dense-grid ct_mul (parallel/mulgrid.py) vs the host aggregation.

The grid program must produce bit-identical bucket weights to the reference
O(|A|*|B|) hashmap semantics (include/pvac/ops/arithmetic.hpp:72-101) for
arbitrary layer counts, duplicate slots and cancelling weights.
"""
import numpy as np
import pytest

import jax

import pvac_hfhe_cppbyv_tpu as pvac
from pvac_hfhe_cppbyv_tpu.core import field as F
from pvac_hfhe_cppbyv_tpu.core import fieldv as FV
from pvac_hfhe_cppbyv_tpu.ops import arithmetic as ar
from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device, disable_device
from pvac_hfhe_cppbyv_tpu.parallel.mulgrid import MulGrid
from pvac_hfhe_cppbyv_tpu.types import Cipher, Layer, Nonce128, RSeed, RRULE_BASE


def _rand_edges(rng, E, L, B):
    lid = rng.integers(0, L, E).astype(np.int32)
    idx = rng.integers(0, B, E).astype(np.int32)
    ch = rng.integers(0, 2, E).astype(np.int8)
    w = rng.integers(0, 1 << 32, (E, 4), dtype=np.uint64).astype(np.uint32)
    w[:, 3] &= 0x7FFFFFFF
    return lid, idx, ch, w


def _slots(lid, idx, ch, B):
    return ((lid.astype(np.int64) * 2 + ch) * B + idx).astype(np.int32)


def test_mulgrid_vs_bruteforce():
    B = 23  # small cyclic group for the brute-force mirror
    rng = np.random.default_rng(7)
    LA, LB, nA, nB = 3, 5, 40, 60
    la_, ia_, ca_, wa_ = _rand_edges(rng, nA, LA, B)
    lb_, ib_, cb_, wb_ = _rand_edges(rng, nB, LB, B)

    # unique-slot pre-aggregation (the grid precondition)
    def agg(lid, idx, ch, w):
        key = _slots(lid, idx, ch, B)
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.zeros((len(uniq), 4), dtype=np.uint64)
        np.add.at(acc, inv, w.astype(np.uint64))
        return uniq, FV.canon_u64_limbs(acc)

    sA, wA = agg(la_, ia_, ca_, wa_)
    sB, wB = agg(lb_, ib_, cb_, wb_)

    mg = MulGrid(type("P", (), {"B": B})(), jax.devices("cpu")[0])
    ow, nz = mg.start(sA, wA, LA, sB, wB, LB)()

    # brute force over raw edge pairs
    want = {}
    for a in range(nA):
        for b in range(nB):
            k = (int(la_[a]), int(lb_[b]), (int(ia_[a]) + int(ib_[b])) % B,
                 int(ca_[a] != cb_[b]))
            wa = FV.to_ints(wa_[a : a + 1])[0]
            wb = FV.to_ints(wb_[b : b + 1])[0]
            want[k] = F.fp_add(want.get(k, 0), F.fp_mul(wa, wb))
    want = {k: v for k, v in want.items() if v != 0}

    got = {}
    for la, lb, c, s in zip(*np.nonzero(nz)):
        got[(int(la), int(lb), int(c), int(s))] = FV.to_ints(
            ow[la, lb, c, s][None, :]
        )[0]
    assert got == want


@pytest.mark.parametrize("k_align", [1, 4, 32])
def test_mulgrid_contraction_padding_is_exact(k_align, monkeypatch):
    """Zero-padding the length-B contraction (K_ALIGN, for cuBLAS's int8
    GEMM) leaves every bucket weight unchanged."""
    from pvac_hfhe_cppbyv_tpu.parallel import mulgrid

    B, L = 23, 3
    rng = np.random.default_rng(11)
    sides = []
    for n in (40, 50):
        lid, idx, ch, w = _rand_edges(rng, n, L, B)
        key, first = np.unique(_slots(lid, idx, ch, B), return_index=True)
        sides += [key, w[first], L]
    prm = type("P", (), {"B": B})()
    dev = jax.devices("cpu")[0]
    want = MulGrid(prm, dev).start(*sides)()
    monkeypatch.setattr(mulgrid, "K_ALIGN", k_align)
    got = MulGrid(prm, dev).start(*sides)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any()


def test_mulgrid_ct_mul_integration(small_keys, monkeypatch):
    """ct_mul through the device grid decrypts correctly and produces the
    identical edge table to the host staging path."""
    pk, sk = small_keys
    eng = enable_device(pk, sk, device=jax.devices("cpu")[0])
    try:
        monkeypatch.setattr(ar, "MULGRID_PAIR_THRESHOLD", 1)
        a, b = 123, 456
        ca, cb = pvac.enc_value_batch(pk, sk, [a, b])

        fin_dev = ar._ct_mul_stage_start(pk, ca, cb)
        s_dev = fin_dev()
        monkeypatch.setattr(ar, "MULGRID_PAIR_THRESHOLD", 1 << 62)
        fin_host = ar._ct_mul_stage_start(pk, ca, cb)
        s_host = fin_host()
        np.testing.assert_array_equal(s_dev["out_lid"], s_host["out_lid"])
        np.testing.assert_array_equal(s_dev["out_idx"], s_host["out_idx"])
        np.testing.assert_array_equal(s_dev["out_ch"], s_host["out_ch"])
        np.testing.assert_array_equal(s_dev["out_w"], s_host["out_w"])

        monkeypatch.setattr(ar, "MULGRID_PAIR_THRESHOLD", 1)
        prod = pvac.ct_mul(pk, ca, cb)
        assert pvac.dec_value(pk, sk, prod) == a * b % pvac.P
        # depth 2 through the grid as well
        sq = pvac.ct_mul(pk, prod, prod)
        assert pvac.dec_value(pk, sk, sq) == pow(a * b, 2, pvac.P)

        # layer-blocked path (prod: 8 layers, 4 occupied -> 2x2 blocks):
        # must emit the same edge SET as the host staging
        monkeypatch.setattr(ar, "MULGRID_LBLOCK", 2)
        s_blk = ar._ct_mul_stage_start(pk, prod, prod)()
        monkeypatch.setattr(ar, "MULGRID_PAIR_THRESHOLD", 1 << 62)
        s_ref = ar._ct_mul_stage_start(pk, prod, prod)()

        def canon_order(s):
            key = np.lexsort((s["out_ch"], s["out_idx"], s["out_lid"]))
            return (s["out_lid"][key], s["out_idx"][key], s["out_ch"][key],
                    s["out_w"][key])
        for gb, gr in zip(canon_order(s_blk), canon_order(s_ref)):
            np.testing.assert_array_equal(gb, gr)
    finally:
        disable_device(pk)


def test_mulgrid_mesh_blocks_use_all_devices(small_keys, monkeypatch):
    """In dp-mesh mode the grid's layer blocks round-robin over every mesh
    device and the blocked product stays bit-identical to the host path."""
    from jax.sharding import Mesh

    pk, sk = small_keys
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest provides 8 virtual cpu devices"
    eng = enable_device(pk, sk, mesh=Mesh(np.array(devs), ("dp",)))
    try:
        a, b = 31337, 271828
        ca, cb = pvac.enc_value_batch(pk, sk, [a, b])
        monkeypatch.setattr(ar, "MULGRID_PAIR_THRESHOLD", 1)
        # force the device grid even though the native host aggregator
        # would claim this small-keyspace product
        monkeypatch.setattr(ar, "_native_agg_viable",
                            lambda *a_, **k_: False)
        prod = pvac.ct_mul(pk, ca, cb)

        # prod has 4 occupied PROD layers; 2x2 blocking -> 4 block dispatches
        monkeypatch.setattr(ar, "MULGRID_LBLOCK", 2)
        rr0 = eng.mulgrid._rr
        s_blk = ar._ct_mul_stage_start(pk, prod, prod)()
        n_blocks = eng.mulgrid._rr - rr0
        assert n_blocks >= 4  # blocks really round-robin over the mesh
        assert len({d for (_, _, _, _, d) in eng.mulgrid._cache}) >= 4

        monkeypatch.setattr(ar, "MULGRID_PAIR_THRESHOLD", 1 << 62)
        s_ref = ar._ct_mul_stage_start(pk, prod, prod)()

        def canon_order(s):
            key = np.lexsort((s["out_ch"], s["out_idx"], s["out_lid"]))
            return (s["out_lid"][key], s["out_idx"][key], s["out_ch"][key],
                    s["out_w"][key])

        for gb, gr in zip(canon_order(s_blk), canon_order(s_ref)):
            np.testing.assert_array_equal(gb, gr)
        assert pvac.dec_value(pk, sk, prod) == a * b % pvac.P
    finally:
        disable_device(pk)
