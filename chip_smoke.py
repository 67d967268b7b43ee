#!/usr/bin/env python
"""On-card smoke test of the device engine on NVIDIA GPUs.

Run from the root of the repository:

    python chip_smoke.py          # one card: phases 1-7 below, in order
    python chip_smoke.py --four   # four cards: the (dp, tp) mesh path only

One card, default ``Params`` (B=337, m=8192, n=16384, LPN 4096/16384):

1. device gate: JAX's first device must be a GPU; prints the card
   (``nvidia-smi``) and whether the native host library loaded;
2. compile the PRF program (both AES plane layouts, 2048 lanes, keys
   derived and expanded on the host), the sigma program (16384 edges) and
   one mulgrid product; prints compile seconds, ``memory_analysis()`` and
   the kernel XLA chose for the int8 GEMM;
3. interop with the C++ reference: the golden ciphertexts in
   ``tests/golden/default`` decrypt, combine and re-serialize exactly;
4. the main path through the public API: 4096 encryptions, 1024 additions,
   512 multiplications, a save/load round trip, every decryption exact, a
   host-engine cross-check and one ``service.Client`` round trip;
5. the device programs against the plain host reference at real widths;
6. times of the plain XLA programs (informative, not a benchmark);
7. the last line of standard output: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero and prints no ok line.  The process is the only
one on the card; ``nvidia-smi`` is its only child.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import pvac_hfhe_cppbyv_tpu as pvac
from pvac_hfhe_cppbyv_tpu import native
from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache
from pvac_hfhe_cppbyv_tpu.crypto import aesv, lpn, matrix
from pvac_hfhe_cppbyv_tpu.parallel.engine import (
    disable_device, enable_device, prf_program,
)

U32 = np.uint32
GOLDEN = "tests/golden/default"
GOLDEN_NAMES = ("a", "b", "sum", "diff", "prod", "scale1000", "zero",
                "recrypt_sum")


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# 1. device gate
# ---------------------------------------------------------------------------

def device_gate(n_cards: int = 1):
    """The GPUs to run on, or exit non-zero; prints the card and the native
    library status.  Returns (devices, card) with card = nvidia-smi's
    "name, power limit" line."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} NVIDIA GPU(s); JAX found "
                 f"{len(devs)} {devs[0].platform!r} device(s)")
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        log(f"nvidia-smi: {line}")
    loaded = native.lib() is not None
    log(f"native host library: {'loaded' if loaded else 'MISSING'}")
    check(loaded, "native host library did not load (ct_mul aggregation "
          "would fall back to pure Python)")
    return devs[:n_cards], smi[0]


# ---------------------------------------------------------------------------
# production-shape inputs, made from a seed
# ---------------------------------------------------------------------------

def prf_seeds(rng, n):
    """n lanes of PRF inputs: (seeds [n, 3] u64, dom hashes [n] u64)."""
    seeds = rng.integers(0, 1 << 63, (n, 3), dtype=np.uint64)
    doms = (pvac.Dom.PRF_R1, pvac.Dom.PRF_R2, pvac.Dom.PRF_R3)
    dh = np.array([lpn.DOM_HASH[doms[i % 3]] for i in range(n)],
                  dtype=np.uint64)
    return seeds, dh


def host_keys(pk, sk, seeds, dh):
    """The AES keys and nonces of the main and Toeplitz streams, derived on
    the host (SHA-256): (keys, nonces, toep_keys, toep_nonces)."""
    keys, nonces = lpn.derive_keys_batch(pk, sk, seeds, dh)
    tkeys, tbase = lpn.derive_keys_batch(
        pk, sk, seeds,
        np.full(len(seeds), lpn.DOM_HASH[lpn.Dom.TOEP], np.uint64))
    return keys, nonces, tkeys, tbase ^ dh


def device_prf(eng, sk, seeds, dh):
    """The engine's PRF cores for seeds: (limbs [N, 4], rej [N])."""
    return eng.prf_cores(*host_keys(eng.pk, sk, seeds, dh))


def sigma_words(pk, rng, n_edges, n_layers=8):
    """[E, 7] u64 σ stream words of fresh-ciphertext form: canon_tag, one of
    n_layers layer seeds, idx < B, sign, random salt."""
    seeds = rng.integers(0, 1 << 63, (n_layers, 3), dtype=np.uint64)
    w = np.zeros((n_edges, 7), dtype=np.uint64)
    w[:, 0] = pk.canon_tag
    w[:, 1:4] = seeds[rng.integers(0, n_layers, n_edges)]
    w[:, 4] = rng.integers(0, pk.prm.B, n_edges)
    w[:, 5] = rng.integers(0, 2, n_edges)
    w[:, 6] = rng.integers(0, 1 << 63, n_edges, dtype=np.uint64)
    return w


def mulgrid_edges(rng, n_layers, n_edges, B):
    """Random edges (lid, idx, ch, w) of one ciphertext with n_layers."""
    w = rng.integers(0, 1 << 32, (n_edges, 4), dtype=np.uint64).astype(U32)
    w[:, 3] &= U32(0x7FFFFFFF)
    return (rng.integers(0, n_layers, n_edges).astype(np.int32),
            rng.integers(0, B, n_edges).astype(np.int32),
            rng.integers(0, 2, n_edges).astype(np.int8), w)


def agg_slots(lid, idx, ch, w, B):
    """Unique-slot pre-aggregation, the mulgrid precondition."""
    key = (lid.astype(np.int64) * 2 + ch) * B + idx
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros((len(uniq), 4), dtype=np.uint64)
    np.add.at(acc, inv, w.astype(np.uint64))
    return uniq.astype(np.int32), pvac.fieldv.canon_u64_limbs(acc)


class Programs:
    """The production-shape device programs with their inputs."""

    def __init__(self, eng, sk, seed=0, prf_lanes=2048, sigma_edges=16384,
                 mul_layers=8, mul_edges=1178):
        rng = np.random.default_rng(seed)
        prm = eng.prm
        self.eng = eng
        self.seeds, self.dh = prf_seeds(rng, prf_lanes)
        self.prf_n, self.prf_args = self.host_prep(sk)
        self.words = sigma_words(eng.pk, rng, sigma_edges)
        ltab, u_pad, buf = eng.compact_sigma_inputs(self.words)
        self.sigma_fn = eng._sigma_compact_fn(sigma_edges, u_pad)
        self.sigma_args = (eng.Hx_dev, eng._canon2, ltab, buf)
        self.mul_L = mul_layers
        self.edges_a = mulgrid_edges(rng, mul_layers, mul_edges, prm.B)
        self.edges_b = mulgrid_edges(rng, mul_layers, mul_edges, prm.B)
        sA, wA = agg_slots(*self.edges_a, prm.B)
        sB, wB = agg_slots(*self.edges_b, prm.B)
        self.slots = (sA, wA, mul_layers, sB, wB, mul_layers)
        self.mul_fn, self.mul_args = eng.mulgrid.prepare(*self.slots)

    def host_prep(self, sk):
        """The host's part of one PRF chunk: SHA-256 key derivation and the
        AES-256 key schedule -> (n_pad, program arguments)."""
        return self.eng.prf_key_args(
            *host_keys(self.eng.pk, sk, self.seeds, self.dh))

    def lowered(self):
        """name -> (lowered program, args).  Both AES plane layouts of the
        PRF; the engine runs the one its platform choice names."""
        import jax

        out = {}
        for gn in (False, True):
            fn = jax.jit(prf_program(self.eng.prm, self.prf_n, aes_gn=gn))
            out[f"prf[{'gn' if gn else 'ng'}]"] = (
                fn.lower(*self.prf_args), self.prf_args)
        out["sigma"] = (self.sigma_fn.lower(*self.sigma_args),
                        self.sigma_args)
        out["mulgrid"] = (self.mul_fn.lower(*self.mul_args), self.mul_args)
        return out


# ---------------------------------------------------------------------------
# 2. compile
# ---------------------------------------------------------------------------

def compile_programs(progs):
    """AOT-compile every program; returns name -> (compiled, args)."""
    out = {}
    for name, (lowered, args) in progs.lowered().items():
        t0 = time.perf_counter()
        compiled = lowered.compile()
        dt = time.perf_counter() - t0
        log(f"compile {name}: {dt:.2f} s; memory_analysis: "
            f"{_mem(compiled.memory_analysis())}")
        gemm = _gemm_kernels(compiled.as_text())
        if gemm:
            log(f"compile {name}: its int8 GEMM runs as {gemm}")
        out[name] = (compiled, args)
    return out


def _gemm_kernels(hlo):
    """The library calls and Triton GEMM fusions XLA:GPU chose for the
    matmuls of a compiled program (none on the CPU)."""
    return sorted(set(re.findall(r'custom_call_target="(__cublas[^"]*)"', hlo))
                  | set(re.findall(r'"kind":"(__triton[^"]*gemm[^"]*)"', hlo)))


def _mem(ma):
    if ma is None:
        return "not reported"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{k.replace('_size_in_bytes', '')}="
                     f"{getattr(ma, k, None)}" for k in keys)


# ---------------------------------------------------------------------------
# 3. interop with the C++ reference
# ---------------------------------------------------------------------------

def interop(golden, device):
    """Golden ciphertexts of the C++ reference through the device engine:
    every decryption, add/sub/scale/mul of a and b, byte-exact re-save."""
    import pathlib

    golden = pathlib.Path(golden)
    pk = pvac.load_pklite(str(golden / "pklite.bin"), with_H=True)
    sk = pvac.load_sk(str(golden / "sk.bin"))
    exp = json.loads((golden / "expected.json").read_text())
    enable_device(pk, sk, device=device)
    try:
        cts = {n: pvac.load_cts(str(golden / f"{n}.ct")) for n in
               GOLDEN_NAMES + ("text",)}
        flat = [cts[n][0] for n in GOLDEN_NAMES]
        got = pvac.dec_value_batch(pk, sk, flat)
        check(got == [exp[n] for n in GOLDEN_NAMES],
              f"golden decrypt mismatch: {got}")
        check(pvac.dec_text(pk, sk, cts["text"]) == exp["text"],
              "golden text mismatch")
        a, b = cts["a"][0], cts["b"][0]
        ops = [pvac.ct_add(pk, a, b), pvac.ct_sub(pk, a, b),
               pvac.ct_scale(pk, a, 1000), pvac.ct_mul(pk, a, b)]
        got = pvac.dec_value_batch(pk, sk, ops)
        want = [exp["sum"], exp["diff"], exp["scale1000"], exp["prod"]]
        check(got == want, f"golden ops mismatch: {got} != {want}")
        with tempfile.TemporaryDirectory() as tmp:
            for n, c in cts.items():
                out = pathlib.Path(tmp) / f"{n}.ct"
                pvac.save_cts(c, str(out))
                check(out.read_bytes() == (golden / f"{n}.ct").read_bytes(),
                      f"golden {n}.ct does not re-serialize byte-exactly")
    finally:
        disable_device(pk)
    log(f"interop: {len(cts)} golden files decrypt, combine and "
        f"re-serialize exactly")


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def main_path(pk, sk, eng, n_enc=4096, n_add=1024, n_mul=512, seed=1):
    """enc -> add -> mul -> save/load -> dec through the public API with
    the engine ``eng`` attached to pk; every plaintext exact."""
    P = pvac.P
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, 1 << 62, n_enc, dtype=np.uint64)]

    t0 = time.perf_counter()
    cts = pvac.enc_value_batch(pk, sk, vals)
    eng.drain()
    log(f"main: enc_value_batch of {n_enc}: "
        f"{time.perf_counter() - t0:.2f} s (first call, compiles included)")

    t0 = time.perf_counter()
    add_pairs = [(cts[i], cts[(i + 1) % n_enc]) for i in range(n_add)]
    sums = pvac.ct_add_batch(pk, add_pairs)
    want_sums = [(vals[i] + vals[(i + 1) % n_enc]) % P for i in range(n_add)]
    log(f"main: ct_add_batch of {n_add}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mul_pairs = [(cts[(2 * i) % n_enc], cts[(2 * i + 1) % n_enc])
                 for i in range(n_mul)]
    prods = pvac.ct_mul_batch(pk, mul_pairs)
    eng.drain()
    want_prods = [vals[(2 * i) % n_enc] * vals[(2 * i + 1) % n_enc] % P
                  for i in range(n_mul)]
    log(f"main: ct_mul_batch of {n_mul}: {time.perf_counter() - t0:.2f} s")

    io = cts[:4] + sums[:2] + prods[:2]
    want_io = vals[:4] + want_sums[:2] + want_prods[:2]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/slice.ct"
        pvac.save_cts(io, path)
        loaded = pvac.load_cts(path)
        pvac.save_cts(loaded, f"{tmp}/again.ct")
        with open(path, "rb") as f1, open(f"{tmp}/again.ct", "rb") as f2:
            check(f1.read() == f2.read(), "save/load/save is not byte-exact")

    t0 = time.perf_counter()
    everything = cts + sums + prods + loaded
    got = pvac.dec_value_batch(pk, sk, everything)
    want = vals + want_sums + want_prods + want_io
    check(got == want, "device decryptions differ from the plaintexts")
    log(f"main: dec_value_batch of {len(everything)}: "
        f"{time.perf_counter() - t0:.2f} s; all exact")

    sample = [cts[0], sums[0], prods[0], loaded[-1]]
    disable_device(pk)
    host = pvac.dec_value_batch(pk, sk, sample)
    pk._engine = eng
    check(host == [vals[0], want_sums[0], want_prods[0], want_io[-1]],
          f"host engine decrypts the sample differently: {host}")
    log("main: host engine decrypts the sample to the same values")

    client = pvac.Client.generate(pk.prm, device=eng.device)
    ev = client.evaluator()
    x, y = client.encrypt([1234567, 7654321])
    out = client.decrypt([ev.mul(x, y), ev.add(x, y)])
    check(out == [1234567 * 7654321 % P, 1234567 + 7654321],
          f"service round trip: {out}")
    log("main: service.Client round trip exact")


# ---------------------------------------------------------------------------
# 5. device programs against the plain host reference
# ---------------------------------------------------------------------------

def host_prf(pk, sk, seeds, dh):
    """prf_R cores on the host: SHA-256 key derivation, AES-256-CTR by the
    native library (AES-NI or its table fallback), LPN parity, Toeplitz and
    the field map in numpy.  -> (limbs [N, 4], rej [N])."""
    prm = pk.prm
    N = seeds.shape[0]
    nb = lpn.n_ybits_blocks(prm)
    keys, nonces, tkeys, tnonces = host_keys(pk, sk, seeds, dh)
    u64s = native.aes256_ctr(keys, nonces, nb).view(U32).reshape(N, 2 * nb, 2)
    top = native.aes256_ctr(tkeys, tnonces, 1).view(U32).reshape(N, 2, 2)
    r, rej = lpn.cores_from_streams(u64s, top, sk.s_words32().reshape(-1),
                                    prm)
    return r, rej.any(axis=-1)


def against_reference(pk, sk, eng, progs, n_sigma_sample=256):
    """PRF, σ and mulgrid, device vs host, at the programs' real widths.
    All of it is integer arithmetic (u32 and int8 -> int32): equality is
    the only tolerance, and no float matmul (so no TF32) is involved."""
    r_dev, rej_dev = device_prf(eng, sk, progs.seeds, progs.dh)
    r_host, rej_host = host_prf(pk, sk, progs.seeds, progs.dh)
    check(np.array_equal(r_dev, r_host), "PRF limbs differ")
    check(np.array_equal(rej_dev, rej_host), "PRF reject flags differ")
    log(f"reference: PRF limbs and reject flags of {len(progs.seeds)} lanes "
        f"bit-identical ({int(rej_host.sum())} rejects)")

    sig, fb, rows = eng.sigma(progs.words)
    sig = np.asarray(sig)[rows]
    fb = np.asarray(fb)[rows]
    pick = np.random.default_rng(2).choice(len(progs.words), n_sigma_sample,
                                           replace=False)
    pick = pick[~fb[pick]]  # flagged lanes are recomputed on the host anyway
    w = progs.words[pick]
    disable_device(pk)
    want = matrix.sigma_words(pk, w[:, 1], w[:, 2], w[:, 3], w[:, 4],
                              w[:, 5], w[:, 6])
    pk._engine = eng
    check(np.array_equal(sig[pick], want), "σ rows differ from the host σ")
    log(f"reference: σ of {len(pick)} sampled edges bit-identical "
        f"({int(fb.sum())} of {len(fb)} lanes flagged for the scalar path)")

    B = pk.prm.B
    L = progs.mul_L
    ow, nz = eng.mulgrid.start(*progs.slots)()
    keys, w_nat = native.mul_cross_agg(*progs.edges_a, *progs.edges_b,
                                       L, L, B)
    pair, sign = (keys // 2), (keys & 1)
    la, lb, idx = pair // B // L, pair // B % L, pair % B
    check(int(nz.sum()) == len(keys), "mulgrid bucket count differs")
    check(np.array_equal(ow[la, lb, idx, sign], w_nat),
          "mulgrid weights differ from the native aggregator")
    log(f"reference: mulgrid {L}x{L} layers, {len(keys)} buckets "
        f"bit-identical to the native aggregator")


# ---------------------------------------------------------------------------
# 6. plain-version times
# ---------------------------------------------------------------------------

def _timed(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def copy_rate(nbytes, reps=5):
    """Measured device copy rate (bytes read + written per second) of an
    elementwise pass over nbytes of u32."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((nbytes // 4,), dtype=jnp.uint32)
    f = jax.jit(lambda v: v ^ jnp.uint32(1))
    return 2 * x.nbytes / min(_timed(f, (x,), reps))


def times(compiled, card, host_prep=None, reps=5, copy_bytes=1 << 30):
    """Warm times of the compiled programs, with the share of a measured
    device copy rate their XLA-counted bytes reach; host_prep() is the
    host's part of one PRF chunk, timed alongside."""
    rate = copy_rate(copy_bytes)
    log(f"time [{card}]: device copy rate {rate / 1e9:.1f} GB/s "
        f"({copy_bytes} B of u32 read + written)")
    if host_prep is not None:
        ts = _timed(host_prep, (), reps)
        log(f"time [{card}]: host key derivation + AES key schedule of one "
            f"PRF chunk: min {min(ts) * 1e3:.3f} ms, median "
            f"{sorted(ts)[len(ts) // 2] * 1e3:.3f} ms")
    for name, (c, args) in compiled.items():
        ts = _timed(c, args, reps)
        cost = c.cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        nbytes = (cost or {}).get("bytes accessed")
        share = (f"; XLA bytes accessed {nbytes:.3e}, "
                 f"{nbytes / min(ts) / rate:.1%} of the copy rate"
                 if nbytes else "; bytes accessed not reported")
        log(f"time [{card}]: {name}: min {min(ts) * 1e3:.3f} ms, "
            f"median {sorted(ts)[len(ts) // 2] * 1e3:.3f} ms over "
            f"{reps} calls{share}")


# ---------------------------------------------------------------------------
# --four: the (dp, tp) mesh on four cards
# ---------------------------------------------------------------------------

def four_cards(devices, prm, n_enc=64, n_mul=16, seed=3):
    """enc -> ct_mul -> ct_add -> dec on a (1, 4) and a (4, 1) mesh, exact
    and equal to the host engine; then the multichip step bit-exact."""
    from pvac_hfhe_cppbyv_tpu.parallel.mesh import make_mesh
    from pvac_hfhe_cppbyv_tpu.parallel.sharding import (
        make_multichip_step, reference_step,
    )

    P = pvac.P
    rng = np.random.default_rng(seed)
    pk, sk = pvac.keygen(prm)
    vals = [int(v) for v in rng.integers(0, 1 << 62, n_enc, dtype=np.uint64)]
    for shape in ((1, 4), (4, 1)):
        t0 = time.perf_counter()
        eng = enable_device(pk, sk, mesh=make_mesh(devices, shape))
        check(eng._s32_tp == (shape[1] > 1), "LPN-tp choice unexpected")
        cts = pvac.enc_value_batch(pk, sk, vals)
        prods = pvac.ct_mul_batch(
            pk, [(cts[2 * i], cts[2 * i + 1]) for i in range(n_mul)])
        sums = pvac.ct_add_batch(pk, list(zip(prods, cts[:n_mul])))
        everything = cts + prods + sums
        got = pvac.dec_value_batch(pk, sk, everything)
        want_p = [vals[2 * i] * vals[2 * i + 1] % P for i in range(n_mul)]
        want = vals + want_p + [(p + v) % P for p, v in zip(want_p, vals)]
        check(got == want, f"mesh {shape}: decryptions differ")
        disable_device(pk)
        check(pvac.dec_value_batch(pk, sk, everything) == got,
              f"mesh {shape}: host engine decrypts differently")
        log(f"four: mesh (dp, tp)={shape}: {n_enc} enc, {n_mul} mul, "
            f"{n_mul} add exact and equal to the host engine "
            f"({time.perf_counter() - t0:.1f} s)")

    tprm = pvac.Params(m_bits=512, n_bits=1024, h_col_wt=48, x_col_wt=32,
                       err_wt=32, lpn_n=256, lpn_t=256)
    step, build = make_multichip_step(make_mesh(devices), tprm,
                                      lanes_per_shard=32)
    args = build(seed=1)
    R, buckets = step(*args)
    want_R, want_b = reference_step(tprm, args)
    check(np.array_equal(np.asarray(R), want_R),
          "multichip step PRF cores differ from the host")
    check(pvac.fieldv.to_ints(np.asarray(buckets)) == want_b,
          "multichip step bucket sums differ from the host")
    log("four: multichip step bit-exact against the host")


# ---------------------------------------------------------------------------

def _phase(name, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card (dp, tp) mesh path")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import jax

    enable_compile_cache()
    devices, card = _phase("1 device gate", device_gate,
                           4 if args.four else 1)
    if args.four:
        _phase("four-card mesh", four_cards, devices, pvac.Params())
    else:
        dev = devices[0]
        pk, sk = pvac.keygen(pvac.Params())
        eng = enable_device(pk, sk, device=dev)
        progs = Programs(eng, sk)
        compiled = _phase("2 compile", compile_programs, progs)
        _phase("3 interop", interop, GOLDEN, dev)
        _phase("4 main path", main_path, pk, sk, eng)
        _phase("5 reference", against_reference, pk, sk, eng, progs)
        _phase("6 times", times, compiled, card,
               host_prep=lambda: progs.host_prep(sk))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
