#!/usr/bin/env python
"""TRUE multi-process validation of the distributed backend (SURVEY §2.3).

Multi-HOST execution needs several machines, but the distributed runtime
itself can be validated on one: this tool launches TWO OS processes, each
owning 4 virtual CPU devices, joined by ``jax.distributed`` into one
8-device global (dp=2, tp=4) mesh.  Every collective (the LPN
partial-parity psum, the ct_mul bucket psum) then actually crosses the
process boundary through the distributed runtime — the same mechanism (and
the same engine/step code, unchanged) that spans hosts.

Legs:
1. make_multichip_step (parallel/sharding.py): the sharded PRF + bucket
   step runs on the global mesh with deterministic inputs; BOTH processes
   verify the psum'd result bit-exactly against a host recomputation.
2. The real engine σ program: identical (pk, sk) in both processes (keys
   serialized by rank 0, loaded by rank 1 — the framework's own key
   serialization), engine attached with the GLOBAL mesh, σ program output
   gathered with multihost_utils.process_allgather and verified bit-exact
   against the host σ path in both processes.

Usage: python tools/multihost_cpu.py            # launcher, forks rank 1
Writes docs/multihost_cpu.json on success (rank 0).
"""
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
COORD = "127.0.0.1:9923"


def worker(pid: int, nproc: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=COORD,
                               num_processes=nproc, process_id=pid)
    import numpy as np
    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import Mesh
    from jax.experimental import multihost_utils

    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.crypto import aesv, lpn, matrix
    from pvac_hfhe_cppbyv_tpu.core import field as F
    from pvac_hfhe_cppbyv_tpu.core import fieldv as FV
    from pvac_hfhe_cppbyv_tpu.parallel.engine import DeviceEngine
    from pvac_hfhe_cppbyv_tpu.parallel.sharding import make_multichip_step
    from pvac_hfhe_cppbyv_tpu.io import serial

    def log(*a):
        print(f"[p{pid}]", *a, flush=True)

    assert jax.device_count() == 4 * nproc, jax.device_count()
    assert jax.local_device_count() == 4
    devs = np.array(jax.devices()).reshape(nproc, 4)
    mesh = Mesh(devs, ("dp", "tp"))
    log(f"global mesh (dp={nproc}, tp=4) across {nproc} processes")

    # ---- leg 1: sharded PRF + bucket-psum step across processes ----
    tprm = pvac.Params(m_bits=512, n_bits=1024, h_col_wt=48, x_col_wt=32,
                      err_wt=32, lpn_n=256, lpn_t=256)
    t0 = time.time()
    step, build = make_multichip_step(mesh, tprm, lanes_per_shard=32)
    args = build(seed=17)  # deterministic -> identical in both processes
    R, buckets = step(*args)
    jax.block_until_ready((R, buckets))
    rk, nlo, nhi, trk, tnlo, tnhi, s32, bucket_ids = args
    N_glob = nlo.shape[0]

    def gather(x, want_rows):
        g = np.asarray(multihost_utils.process_allgather(x, tiled=True))
        if g.ndim == 3:  # replicated input: stacked copies
            g = g[0]
        return g[:want_rows]

    R = gather(R, N_glob)
    buckets = gather(buckets, tprm.B)
    N = N_glob
    nblocks = lpn.n_ybits_blocks(tprm)
    rkm = aesv.rk_masks_from_packed(rk, N)
    planes = aesv.counters_to_planes(nlo, nhi, nblocks)
    words = aesv.planes_to_words(aesv.encrypt_planes(rkm, planes), nblocks)
    u64s = np.stack([words[:, :, 0::2].reshape(N, -1),
                     words[:, :, 1::2].reshape(N, -1)], axis=-1)
    trkm = aesv.rk_masks_from_packed(trk, N)
    tplanes = aesv.counters_to_planes(tnlo, tnhi, 1)
    twords = aesv.planes_to_words(aesv.encrypt_planes(trkm, tplanes), 1)
    top_u = np.stack([twords[:, :, 0::2].reshape(N, -1),
                      twords[:, :, 1::2].reshape(N, -1)], axis=-1)
    want_R, _ = lpn.cores_from_streams(u64s, top_u, s32, tprm)
    assert np.array_equal(R, np.asarray(want_R)), \
        f"p{pid}: cross-process PRF psum != host"
    want = [0] * tprm.B
    for v, b in zip(FV.to_ints(want_R), bucket_ids):
        want[int(b)] = F.fp_add(want[int(b)], v)
    assert FV.to_ints(np.asarray(buckets)) == want, \
        f"p{pid}: cross-process bucket psum != host"
    t_leg1 = time.time() - t0
    log(f"leg 1 ok: PRF psum + bucket psum bit-exact across processes "
        f"({t_leg1:.1f}s)")

    # ---- leg 2: real engine σ program on the cross-process mesh ----
    t0 = time.time()
    kdir = str(REPO / "build" / "multihost_keys")
    prm = pvac.small_test_params()
    if pid == 0:
        os.makedirs(kdir, exist_ok=True)
        pk, sk = pvac.keygen(prm)
        serial.save_pklite(pk, f"{kdir}/pk.bin.tmp")
        serial.save_sk(sk, f"{kdir}/sk.bin.tmp")
        os.replace(f"{kdir}/pk.bin.tmp", f"{kdir}/pk.bin")
        os.replace(f"{kdir}/sk.bin.tmp", f"{kdir}/sk.bin")
    else:
        for _ in range(600):
            if os.path.exists(f"{kdir}/pk.bin") and \
                    os.path.exists(f"{kdir}/sk.bin"):
                break
            time.sleep(0.5)
        time.sleep(0.5)
        pk = serial.load_pklite(f"{kdir}/pk.bin", with_H=True)
        sk = serial.load_sk(f"{kdir}/sk.bin")
    multihost_utils.sync_global_devices("pvac-mh-keys")

    eng = DeviceEngine(pk, sk, mesh=mesh)
    assert eng.tp == 4 and eng.n_dev == nproc
    E = 64 * nproc  # one exact dp-divisible chunk
    rng = np.random.default_rng(23)  # identical words in both processes
    words = np.zeros((E, 7), dtype=np.uint64)
    words[:, 0] = np.uint64(pk.canon_tag)
    words[:, 1:4] = rng.integers(0, 1 << 62, (E, 3), dtype=np.uint64)
    words[:, 4] = rng.integers(0, prm.B, E, dtype=np.uint64)
    words[:, 5] = rng.integers(0, 2, E, dtype=np.uint64)
    words[:, 6] = rng.integers(0, 1 << 62, E, dtype=np.uint64)
    sig, fb = eng._sigma_padded(words)
    jax.block_until_ready(sig)
    sig_g = np.asarray(multihost_utils.process_allgather(sig, tiled=True))
    fb_g = np.asarray(multihost_utils.process_allgather(fb, tiled=True))
    assert not fb_g[:E].any(), "unexpected fallback lanes"
    # host recomputation (engine not attached to pk -> host path)
    cols = [matrix._scalar_sigma_row(pk, prm, words[e]) for e in range(E)]
    want_sig = np.stack(cols)
    assert np.array_equal(sig_g[:E], want_sig), \
        f"p{pid}: cross-process sigma != host"
    t_leg2 = time.time() - t0
    log(f"leg 2 ok: engine sigma program bit-exact on the cross-process "
        f"(dp={nproc}, tp=4) mesh ({t_leg2:.1f}s)")

    if pid == 0:
        out = {
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
            "processes": nproc,
            "devices_per_process": 4,
            "global_mesh": f"(dp={nproc}, tp=4)",
            "leg1_sharded_step_s": round(t_leg1, 1),
            "leg2_engine_sigma_s": round(t_leg2, 1),
            "note": (
                "two OS processes joined by jax.distributed; psum and "
                "sigma collectives cross the process boundary through the "
                "distributed runtime (the mechanism that spans hosts); "
                "results bit-exact vs host in BOTH processes"
            ),
        }
        with open(REPO / "docs" / "multihost_cpu.json", "w") as f:
            json.dump(out, f, indent=1)
        log("wrote docs/multihost_cpu.json")
    multihost_utils.sync_global_devices("pvac-mh-done")
    log("done")
    sys.stdout.flush()
    if pid != 0:
        # the distributed client's shutdown can hang on lingering service
        # threads; all verification output is flushed, so exit hard.
        os._exit(0)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    nproc = 2
    procs = []
    for pid in range(1, nproc):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--worker", str(pid), str(nproc)],
        ))
    ok = False
    try:
        worker(0, nproc)
        ok = True
    finally:
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
        if ok and all((p.returncode or 0) == 0 for p in procs):
            print("multihost_cpu: ALL OK", flush=True)
            os._exit(0)  # coordinator shutdown can hang too


if __name__ == "__main__":
    main()


if __name__ == "__main__":
    main()
