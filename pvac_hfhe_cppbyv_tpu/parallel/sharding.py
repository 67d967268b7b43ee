"""Multi-chip sharded pipelines (shard_map over a (dp, tp) mesh).

Parallelism map (designed, not ported — the reference is single-threaded,
SURVEY.md §2.3):

- ``dp`` shards the PRF-lane / ciphertext batch axis.  Lanes are
  independent; no communication.
- ``tp`` shards the LPN secret contraction: each shard holds a slice of the
  4096-bit secret and of each sample row, computes a partial inner-product
  parity, and the full dot is a ``psum`` over the device interconnect
  (mod-2 after the sum).
  The ct_mul-style (layer-pair, idx) bucket accumulation is likewise
  computed shard-locally and ``psum``-reduced.

The full step below is what ``__graft_entry__.dryrun_multichip`` compiles
and runs on a virtual device mesh.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..core import fieldv as FV
from ..crypto import aesv, lpn, toeplitz as TOEP
from ..params import Params

U32 = np.uint32


def make_multichip_step(mesh: Mesh, prm: Params, lanes_per_shard: int = 64):
    """Build the jitted sharded homomorphic step.

    Inputs (global shapes):
      rk_packed  [1920, N/32]   AES round keys, lane-packed  (dp over lanes)
      nlo, nhi   [N]            CTR nonces                    (dp)
      trk_packed [1920, N/32]   toep round keys               (dp)
      tnlo, tnhi [N]            toep nonces                   (dp)
      s32        [2*s_words64]  LPN secret words              (tp slices)
      bucket     [N]            output bucket id per lane     (dp)

    Step: N prf_R cores (AES keystream dp-local; LPN dot = partial parity
    + psum over tp; Toeplitz + field mapping dp-local), then a bucketed
    field accumulation psum-reduced over both axes — the communication
    pattern of a sharded ct_mul.

    Returns (step_fn, global_input_builder).
    """
    dp = mesh.shape["dp"]
    tp = mesh.shape["tp"]
    N = lanes_per_shard * dp
    assert lanes_per_shard % 32 == 0
    sw64 = prm.s_words64
    assert sw64 % tp == 0, f"s_words64={sw64} not divisible by tp={tp}"
    loc_w = sw64 // tp
    rows = min(127, prm.lpn_t)
    nblocks = lpn.n_ybits_blocks(prm)
    n_buckets = prm.B

    def inner(rk, nlo, nhi, trk, tnlo, tnhi, s32_sh, bucket):
        nloc = lanes_per_shard
        # --- AES-CTR keystreams (dp-local) ---
        rkm = aesv.rk_masks_from_packed(rk, nloc)
        planes = aesv.counters_to_planes(nlo, nhi, nblocks)
        words = aesv.planes_to_words(aesv.encrypt_planes(rkm, planes), nblocks)
        lo = words[:, :, 0::2].reshape(nloc, -1)
        hi = words[:, :, 1::2].reshape(nloc, -1)
        u64s = jnp.stack([lo, hi], axis=-1)  # [nloc, 2*nblocks, 2]

        # --- LPN rows: tp shards the contraction over secret words ---
        t_idx = lax.axis_index("tp")
        stride = sw64 + 1
        base_idx = (np.arange(rows)[:, None] * stride
                    + np.arange(loc_w)[None, :])  # [rows, loc_w]
        idx = jnp.asarray(base_idx) + t_idx * loc_w
        rows_u = jnp.take(u64s, idx.reshape(-1), axis=1).reshape(
            nloc, rows, loc_w, 2
        )
        s_loc = s32_sh.reshape(loc_w, 2)
        acc = rows_u & s_loc[None, None, :, :]
        folded = lpn._xor_reduce_last(acc.reshape(nloc, rows, 2 * loc_w))
        # partial parity -> integer popcount parity, summed across tp
        from ..core import bitvec as BV

        partial = (BV.popcount32(folded) & U32(1)).astype(jnp.int32)
        dot = (lax.psum(partial, "tp") % 2).astype(U32)  # [nloc, rows]

        # --- noise bits + y (identical on every tp shard) ---
        noise_idx = np.arange(rows) * stride + sw64
        nz = u64s[:, noise_idx, :]
        den = prm.lpn_tau_den
        e = ((nz[..., 0] & U32(den - 1)) < U32(prm.lpn_tau_num)).astype(U32)
        y = dot ^ e
        cols = []
        for k in range(4):
            lo_b, hi_b = 32 * k, min(32 * (k + 1), rows)
            if lo_b >= rows:
                cols.append(jnp.zeros((nloc,), dtype=U32))
                continue
            sh = jnp.arange(hi_b - lo_b, dtype=U32)
            cols.append(lpn._xor_reduce_last(y[:, lo_b:hi_b] << sh))
        y4 = jnp.stack(cols, axis=-1)

        # --- toeplitz top + conv + field map (dp-local) ---
        trkm = aesv.rk_masks_from_packed(trk, nloc)
        tplanes = aesv.counters_to_planes(tnlo, tnhi, 1)
        twords = aesv.planes_to_words(aesv.encrypt_planes(trkm, tplanes), 1)
        top4 = jnp.stack(
            [twords[:, 0, 0], twords[:, 0, 1], twords[:, 0, 2], twords[:, 0, 3]],
            axis=-1,
        )
        out127 = TOEP.conv127(y4, top4)
        R = FV.canon(out127)
        one = jnp.broadcast_to(jnp.asarray([1, 0, 0, 0], dtype=U32), R.shape)
        R = FV.select(FV.is_zero(R), one, R)  # [nloc, 4]

        # --- bucketed field accumulation (the ct_mul reduction pattern):
        # 16-bit half-limb segment sums shard-locally, then psum over the
        # whole mesh and a Mersenne reduction back to canonical form.
        halves = []
        for k in range(4):
            halves.append(R[:, k] & U32(0xFFFF))
            halves.append(R[:, k] >> U32(16))
        hmat = jnp.stack(halves, axis=-1)  # [nloc, 8]
        seg = jax.ops.segment_sum(hmat, bucket, num_segments=n_buckets)
        seg = lax.psum(seg, "dp")
        seg = lax.psum(seg, "tp") // tp  # every tp shard added the same sums
        # digits (< 2^32 each, weight 2^16k) -> canonical field elements
        z = [jnp.zeros((n_buckets,), dtype=U32)] * 8
        digs = []
        c = jnp.zeros((n_buckets,), dtype=U32)
        for k in range(8):
            t = seg[:, k] + c
            digs.append(t & U32(0xFFFF))
            c = t >> U32(16)
        digs.append(c & U32(0xFFFF))
        digs.append(c >> U32(16))
        digs += [jnp.zeros_like(c)] * (16 - len(digs))
        zl = [digs[2 * k] | (digs[2 * k + 1] << U32(16)) for k in range(8)]
        L = jnp.stack([zl[0], zl[1], zl[2], zl[3] & U32(0x7FFFFFFF)], axis=-1)
        zl.append(jnp.zeros_like(zl[0]))
        H = jnp.stack(
            [(zl[3 + k] >> U32(31)) | (zl[4 + k] << U32(1)) for k in range(4)],
            axis=-1,
        )
        x, _ = FV._add128(jnp, L, H)
        bucket_sums = FV.canon(x)  # [n_buckets, 4]
        return R, bucket_sums

    step = jax.jit(
        jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(
                P(None, "dp"), P("dp"), P("dp"),
                P(None, "dp"), P("dp"), P("dp"),
                P("tp"), P("dp"),
            ),
            out_specs=(P("dp", None), P(None, None)),
        )
    )

    def build_inputs(seed: int = 0):
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
        tkeys = rng.integers(0, 256, size=(N, 32), dtype=np.uint8)
        # lane-pack per dp shard so each shard's [1920, lanes/32] block is
        # self-contained
        rk = np.concatenate(
            [aesv.expand_keys_packed(keys[i * lanes_per_shard:(i + 1) * lanes_per_shard])
             for i in range(dp)], axis=1,
        )
        trk = np.concatenate(
            [aesv.expand_keys_packed(tkeys[i * lanes_per_shard:(i + 1) * lanes_per_shard])
             for i in range(dp)], axis=1,
        )
        nonces = rng.integers(0, 1 << 63, size=(N,), dtype=np.uint64)
        tnonces = rng.integers(0, 1 << 63, size=(N,), dtype=np.uint64)
        s32 = rng.integers(0, 1 << 32, size=(2 * sw64,), dtype=np.uint64).astype(U32)
        bucket = (np.arange(N) % n_buckets).astype(np.int32)
        return (
            rk,
            (nonces & np.uint64(0xFFFFFFFF)).astype(U32),
            (nonces >> np.uint64(32)).astype(U32),
            trk,
            (tnonces & np.uint64(0xFFFFFFFF)).astype(U32),
            (tnonces >> np.uint64(32)).astype(U32),
            s32,
            bucket,
        )

    return step, build_inputs


def reference_step(prm: Params, args):
    """Host (numpy) recomputation of the step from the same inputs:
    returns (R [N, 4] u32 limbs, bucket sums as a list of B field ints)."""
    from ..core import field as F

    rk, nlo, nhi, trk, tnlo, tnhi, s32, bucket = args
    N = nlo.shape[0]
    nblocks = lpn.n_ybits_blocks(prm)

    def stream(packed, lo, hi, nb):
        rkm = aesv.rk_masks_from_packed(packed, N)
        planes = aesv.counters_to_planes(lo, hi, nb)
        words = aesv.planes_to_words(aesv.encrypt_planes(rkm, planes), nb)
        return np.stack([words[:, :, 0::2].reshape(N, -1),
                         words[:, :, 1::2].reshape(N, -1)], axis=-1)

    R, _ = lpn.cores_from_streams(stream(rk, nlo, nhi, nblocks),
                                  stream(trk, tnlo, tnhi, 1), s32, prm)
    sums = [0] * prm.B
    for v, b in zip(FV.to_ints(R), bucket):
        sums[int(b)] = F.fp_add(sums[int(b)], v)
    return np.asarray(R), sums
