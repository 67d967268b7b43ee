"""Device ct_mul: dense-grid cyclic convolution as int8 matmuls.

The reference's ct_mul hot loop (include/pvac/ops/arithmetic.hpp:79-87) is an
O(|A|*|B|) hashmap aggregation keyed by (layer-pair, (idx_a+idx_b) mod B,
sign_a XOR sign_b).  Because the key depends only on each edge's
(layer, idx, sign) slot, aggregating edge weights per slot FIRST and then
combining slots is mathematically identical — and the slot-level combine is a
batch of cyclic convolutions of length B over F_p:

    out[la, lb, c, s] = sum_{i, sa}  WA[la, sa, i] * WB[lb, sa^s, (c-i) mod B]

This module evaluates those convolutions as integer matmuls:

- field elements are decomposed into D7=19 digits of 7 bits, so int8 x int8
  products accumulated over the B=337-long contraction stay exact in int32;
- per B-side digit d2, ONE int8 matmul [LA*2*D7, B] @ [B, LB*2*B] computes
  every (A-digit, layer-pair, output-index) partial sum;
- partial sums fold into 16-bit digit planes with static shifts using
  2^127 = 1 (mod p): weight 2^(7*(d1+d2)) wraps to 2^((7*(d1+d2)) mod 127),
  so the running accumulator is 11 u32 planes regardless of depth;
- planes carry-propagate and Mersenne-fold to canonical limbs on device.

Cost scales with LA*LB*B^2 (layer grid), NOT with |A|*|B| (edge pairs): a
depth-3 product (|A|=|B|~4e4 edges -> 1.8e9 pairs on the host path) is ~20
matmuls of a few ms here.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..core import fieldv as FV

U32 = np.uint32
D7 = 19          # ceil(128 / 7) digits of 7 bits cover any 128-bit weight
MAXP = 1 << 25   # int8 x int8 x 337 partial sums < 2^25
# The contraction (length B) is zero-padded to a multiple of K_ALIGN: cuBLAS
# refuses an int8 GEMM whose K is not a multiple of 4 (B = 337 fails with
# CUBLAS_STATUS_NOT_SUPPORTED), and zero terms leave every sum exact.
K_ALIGN = 32


def _digits7(W):
    """[..., 4] u32 limbs -> [..., D7] int8 digits of 7 bits."""
    digs = []
    for d in range(D7):
        off = 7 * d
        w0, sh = off // 32, off % 32
        v = W[..., w0] >> U32(sh)
        if sh > 32 - 7 and w0 + 1 < 4:
            v = v | (W[..., w0 + 1] << U32(32 - sh))
        digs.append((v & U32(0x7F)).astype(jnp.int8))
    return jnp.stack(digs, axis=-1)


def _planes_to_limbs(planes):
    """11 u32 16-bit-digit planes [..., 11] -> canonical field limbs [..., 4].

    value = sum_q planes[q] * 2^(16q) < 2^(176+16); carry-propagate, then fold
    with 2^128 = 2 (mod p).
    """
    digs = []
    c = jnp.zeros_like(planes[..., 0])
    for q in range(11):
        t = planes[..., q] + c
        digs.append(t & U32(0xFFFF))
        c = t >> U32(16)
    digs.append(c & U32(0xFFFF))   # q = 11
    digs.append(c >> U32(16))      # q = 12
    while len(digs) < 14:
        digs.append(jnp.zeros_like(c))
    l = [digs[2 * m] | (digs[2 * m + 1] << U32(16)) for m in range(6)]
    lo = jnp.stack([l[0], l[1], l[2], l[3]], axis=-1)
    # bits 128.. contribute 2 * (l4 + 2^32 l5)  (2^128 = 2 mod p)
    h2lo = l[4] << U32(1)
    h2mid = (l[5] << U32(1)) | (l[4] >> U32(31))
    h2hi = l[5] >> U32(31)
    hi = jnp.stack([h2lo, h2mid, h2hi, jnp.zeros_like(h2hi)], axis=-1)
    return FV.add(FV.canon(lo), FV.canon(hi))


@functools.lru_cache(maxsize=None)
def _conv_table(Bmod: int) -> np.ndarray:
    """Midx[i, c] = (c - i) mod B — the circulant gather pattern."""
    i = np.arange(Bmod)[:, None]
    c = np.arange(Bmod)[None, :]
    return ((c - i) % Bmod).astype(np.int32)


def build_mul_grid_fn(Bmod: int, LAp: int, LBp: int, nAp: int, nBp: int,
                      device=None):
    """Compile the dense-grid ct_mul program for padded shapes.

    Signature: (slotsA [nAp] i32, wA [nAp, 4] u32, slotsB, wB) ->
      (out_w [LAp, LBp, Bmod, 2, 4] u32 canonical, nz [LAp, LBp, Bmod, 2] bool)

    slot = (layer*2 + sign) * B + idx; padding rows use slot = LAp*2*B (a
    scratch row sliced away).  Edges sharing a slot must be pre-aggregated on
    the host (their weights field-summed) — see ct_mul staging.
    """
    Midx = jnp.asarray(_conv_table(Bmod))
    kpad = _pad_mult(Bmod, K_ALIGN) - Bmod

    def densify(slots, w, Lp):
        dense = jnp.zeros((Lp * 2 * Bmod + 1, 4), dtype=jnp.uint32)
        dense = dense.at[slots].set(w)
        return dense[: Lp * 2 * Bmod]

    def run(slotsA, wA, slotsB, wB):
        WA = densify(slotsA, wA, LAp)                     # [LAp*2*B, 4]
        WB = densify(slotsB, wB, LBp)
        A8 = _digits7(WA).reshape(LAp, 2, Bmod, D7)       # int8
        A8m = jnp.transpose(A8, (0, 1, 3, 2)).reshape(LAp * 2 * D7, Bmod)
        A8m = jnp.pad(A8m, ((0, 0), (0, kpad)))
        B8 =_digits7(WB).reshape(LBp * 2, Bmod, D7)      # [G, B, D7]

        G = LBp * 2
        planes = [
            jnp.zeros((LAp * 2, G, Bmod), dtype=jnp.uint32) for _ in range(11)
        ]
        for d2 in range(D7):
            # circulant for digit d2: [B(i), G*B(c)]
            Bc = jnp.transpose(B8[:, Midx, d2], (1, 0, 2)).reshape(
                Bmod, G * Bmod
            )
            Bc = jnp.pad(Bc, ((0, kpad), (0, 0)))
            P =jax.lax.dot_general(
                A8m, Bc, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).reshape(LAp * 2, D7, G, Bmod)
            for d1 in range(D7):
                v = P[:, d1].astype(jnp.uint32)           # < 2^25
                r = (7 * (d1 + d2)) % 127
                base, s = r // 16, r % 16
                planes[base] = planes[base] + ((v << U32(s)) & U32(0xFFFF))
                planes[base + 1] = planes[base + 1] + (
                    ((v >> U32(16 - s)) if s else (v >> U32(16))) & U32(0xFFFF)
                )
                if 32 - s < 25:
                    # base <= 7 (r <= 126), so base+2 <= 9 < 11
                    planes[base + 2] = planes[base + 2] + (
                        (v >> U32(32 - s)) & U32(0xFFFF)
                    )
        vals = _planes_to_limbs(jnp.stack(planes, axis=-1))  # [LAp*2, G, B, 4]
        vals = vals.reshape(LAp, 2, LBp, 2, Bmod, 4)
        outP = FV.add(vals[:, 0, :, 0], vals[:, 1, :, 1])   # sa == sb -> +
        outM = FV.add(vals[:, 0, :, 1], vals[:, 1, :, 0])   # sa != sb -> -
        out = jnp.stack([outP, outM], axis=-2)              # [LA, LB, B, 2, 4]
        nz = (out != 0).any(axis=-1)
        return out, nz

    # pin execution via jax.default_device at call time (jit(device=) is
    # deprecated and its legacy lowering path compiles pathologically —
    # see engine._jit)
    jfn = jax.jit(run)

    def call(*args):
        with jax.default_device(device):
            return jfn(*args)

    call.lower = jfn.lower  # ahead-of-time compile, as jax.jit has
    return call


def _pad_mult(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class MulGrid:
    """Per-engine cache of compiled dense-grid ct_mul programs.

    ``devices`` may be a list: successive dispatches round-robin over it, so
    the independent layer blocks of one big product (and the products of a
    batch) run on all mesh devices concurrently with zero collectives —
    each block's output is fetched straight from the device that computed
    it."""

    def __init__(self, prm, devices):
        self.Bmod = prm.B
        if not isinstance(devices, (list, tuple)):
            devices = [devices]
        self.devices = list(devices)
        self._rr = 0
        self._cache = {}

    def _fn(self, LAp, LBp, nAp, nBp, dev):
        key = (LAp, LBp, nAp, nBp, dev)
        fn = self._cache.get(key)
        if fn is None:
            fn = build_mul_grid_fn(self.Bmod, LAp, LBp, nAp, nBp,
                                   device=dev)
            self._cache[key] = fn
        return fn

    def prepare(self, slotsA, wA, LA, slotsB, wB, LB):
        """The compiled-program wrapper and padded arguments of one product.

        slots*/w* are host arrays of PRE-AGGREGATED (unique-slot) edges.
        Shapes pad: layer counts to a multiple of 4, edge counts to powers of
        two, so the jit cache stays small across a depth sweep.
        """
        B = self.Bmod
        LAp, LBp = _pad_mult(LA, 4), _pad_mult(LB, 4)
        nAp = 1 << max(5, (len(slotsA) - 1).bit_length())
        nBp = 1 << max(5, (len(slotsB) - 1).bit_length())

        def pad(slots, w, n_pad, Lp):
            s = np.full(n_pad, Lp * 2 * B, dtype=np.int32)  # scratch row
            s[: len(slots)] = slots
            ww = np.zeros((n_pad, 4), dtype=U32)
            ww[: len(slots)] = w
            return s, ww

        dev = self.devices[self._rr % len(self.devices)]
        self._rr += 1
        sA, wAp = pad(slotsA, wA, nAp, LAp)
        sB, wBp = pad(slotsB, wB, nBp, LBp)
        return self._fn(LAp, LBp, nAp, nBp, dev), (sA, wAp, sB, wBp)

    def start(self, slotsA, wA, LA, slotsB, wB, LB):
        """Dispatch one product (see :meth:`prepare`); returns finalize() ->
        (out_w, nz) numpy."""
        fn, args = self.prepare(slotsA, wA, LA, slotsB, wB, LB)
        out = fn(*args)

        def finalize():
            ow, nz = out
            del nz  # stays on device: recomputing any(-1) on the fetched
            # weights is cheaper than transferring the mask
            oww = np.asarray(ow)[:LA, :LB]
            return oww, oww.any(axis=-1)

        return finalize
