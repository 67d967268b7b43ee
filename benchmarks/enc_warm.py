#!/usr/bin/env python
"""Warm-engine encryption throughput at fixed batch sizes.

Measures enc_value_batch at batches 256 and 512 on the attached
accelerator, several reps each with the σ queue drained inside every
timed window, plus a decrypt spot-check.  Writes docs/enc_warm.json —
the artifact behind any "warm enc ct/s" figure in the docs.
"""
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import jax

    import pvac_hfhe_cppbyv_tpu as pvac
    from pvac_hfhe_cppbyv_tpu.config import enable_compile_cache

    enable_compile_cache()
    from pvac_hfhe_cppbyv_tpu.parallel.engine import enable_device

    prm = pvac.Params()
    pk, sk = pvac.keygen(prm)
    eng = enable_device(pk, sk, device=jax.devices()[0])
    out = {"date": time.strftime("%Y-%m-%d %H:%M:%S"),
           "device": str(jax.devices()[0]), "rows": []}
    base = 0
    for nb in (256, 512):
        vals = list(range(base, base + nb))
        t0 = time.time()
        pvac.enc_value_batch(pk, sk, vals)
        eng.drain()
        warm = time.time() - t0
        reps = []
        for i in range(4):
            vs = [v + (i + 1) * nb for v in vals]
            t0 = time.time()
            cts = pvac.enc_value_batch(pk, sk, vs)
            eng.drain()
            reps.append(round(time.time() - t0, 3))
        assert pvac.dec_value_batch(pk, sk, cts[:2]) == vs[:2]
        row = {
            "batch": nb,
            "warmup_s": round(warm, 1),
            "reps_s": reps,
            "best_ct_s": round(nb / min(reps), 1),
            "median_ct_s": round(nb / sorted(reps)[len(reps) // 2], 1),
        }
        out["rows"].append(row)
        print(f"enc({nb}): best {row['best_ct_s']} ct/s, "
              f"median {row['median_ct_s']} ct/s (reps {reps})", flush=True)
        base += nb * 8
    path = pathlib.Path(__file__).resolve().parent.parent / "docs" / \
        "enc_warm.json"
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}")
    os._exit(0)


if __name__ == "__main__":
    main()
