"""Device engine: jitted XLA pipelines for the scheme's hot paths.

Attach an engine to a public key with :func:`enable_device` and every
operation (enc/dec/mul/recrypt/text) transparently routes its bulk compute —
AES-CTR keystreams + LPN + Toeplitz (prf_R cores) and SHA-CTR + H-gather
(σ generation) — through jitted XLA programs on the attached devices, while
the host keeps key derivation, layer bookkeeping and field-scalar glue.

Shapes are static per jit cache entry; lane counts are padded to the next
power of two (at least the platform's ``min_lanes``) to bound
recompilation.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..crypto import aesv, lpn, shactr
from ..types import PubKey, SecKey

U32 = np.uint32


def _pad_pow2(n: int, lo: int = 32) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


#: Per-platform program choices, decided from the platform alone:
#: ``aes_gn`` picks the G-major bitsliced plane layout (the faster one on
#: an H100); ``min_lanes`` is the smallest padded lane count of a PRF or σ
#: program, which bounds how many shapes get compiled.
PLATFORM_CHOICES = {
    "cpu": {"aes_gn": False, "min_lanes": 32},
    "gpu": {"aes_gn": True, "min_lanes": 2048},
}


def platform_choices(platform: str) -> dict:
    """The program choices for a device platform; unknown platforms raise."""
    try:
        return PLATFORM_CHOICES[platform]
    except KeyError:
        raise ValueError(
            f"no device programs for platform {platform!r}; the engine runs "
            f"on {sorted(PLATFORM_CHOICES)}") from None


def prf_program(prm, n_lanes: int, tp_axis: str | None = None,
                aes_gn: bool = False):
    """The single-device prf_R-core forward program (jittable, pure).

    (rk_packed [1920, n/32] u32, nlo, nhi [n], trk_packed [1920, n/32],
    tnlo, tnhi, s32 [2*s_words64]) -> (field limbs [n, 4], rejection flags
    [n]).  The key inputs are host-expanded lane-packed AES-256 round-key
    planes (aesv.expand_keys_packed): the key schedule and the SHA-256 key
    derivation stay on the host, because XLA compiles their long chains of
    tiny bit-sliced ops slowly (minutes per program shape on the GPU).

    aes_gn selects the G-major plane layout of the bitsliced keystream
    (aesv.counters_to_planes_gn); both layouts are bit-identical.

    With tp_axis set the program is a shard_map BODY on a (dp, tp) mesh:
    n_lanes is the per-dp-rank lane count, s32 is the rank's LOCAL secret
    slice (P(tp_axis)), and the LPN contraction runs tensor-parallel with
    one psum of partial parities (lpn.cores_from_streams_tp).
    """
    nblocks = lpn.n_ybits_blocks(prm)

    def _keystream_words(rk_packed, nlo, nhi, nb):
        rk = aesv.rk_masks_from_packed(rk_packed, n_lanes)
        if aes_gn:
            planes = aesv.counters_to_planes_gn(nlo, nhi, nb)
            out = aesv.encrypt_planes_gn(rk, planes)
            return aesv.planes_to_words_gn(out, nb)
        planes = aesv.counters_to_planes(nlo, nhi, nb)
        out = aesv.encrypt_planes(rk, planes)
        return aesv.planes_to_words(out, nb)

    def core(rk_packed, nlo, nhi, trk_packed, tnlo, tnhi, s32):
        twords = _keystream_words(trk_packed, tnlo, tnhi, 1)  # [N, 1, 4]
        tlo = twords[:, :, 0::2].reshape(n_lanes, -1)
        thi = twords[:, :, 1::2].reshape(n_lanes, -1)
        top_u = jnp.stack([tlo, thi], axis=-1)  # [N, 2, 2]

        words = _keystream_words(rk_packed, nlo, nhi, nblocks)  # [N, B, 4]
        lo = words[:, :, 0::2].reshape(n_lanes, -1)
        hi = words[:, :, 1::2].reshape(n_lanes, -1)
        u64s = jnp.stack([lo, hi], axis=-1)  # [N, 2*nblocks, 2]

        if tp_axis is None:
            r, rej = lpn.cores_from_streams(u64s, top_u, s32, prm)
        else:
            r, rej = lpn.cores_from_streams_tp(u64s, top_u, s32, prm,
                                               axis_name=tp_axis)
        return r, rej.any(axis=-1)

    return core


class DeviceEngine:
    """Holds device-resident key material and jit caches for one (pk, sk).

    sk material on device is limited to the LPN secret bit-vector (needed by
    the row-parity kernel) and the key-derivation message prefix.  The
    device platform ("cpu" or "gpu") fixes the program choices
    (:data:`PLATFORM_CHOICES`); any other platform raises.
    """

    def __init__(self, pk: PubKey, sk: SecKey | None = None, device=None,
                 mesh: Mesh | None = None):
        self.pk = pk
        self.prm = pk.prm
        # Multi-chip mode: a 1-D mesh (or any mesh passed with one axis)
        # becomes a pure "dp" axis — every engine program is lane-/edge-
        # parallel with zero cross-lane dependencies, so GSPMD shards the
        # batch axis over all chips with no collectives and key material
        # (H, LPN secret, layer seed tables) is replicated.
        #
        # A 2-D mesh is treated as ("dp", "tp") and additionally runs σ
        # generation TENSOR-parallel: H lives column-sharded P(None, "tp")
        # (each chip holds m_bits/tp of every H row) and the σ gather-XOR
        # partitions over the word axis with zero collectives — the draw
        # streams are recomputed per tp rank (cheap elementwise work) while
        # the memory-heavy H traffic and σ residency split tp-ways.
        if mesh is not None:
            marr = np.asarray(mesh.devices)
            if marr.ndim == 2 and marr.shape[1] > 1:
                self.mesh = Mesh(marr, axis_names=("dp", "tp"))
                self.tp = marr.shape[1]
                self.n_dev = marr.shape[0]  # dp extent (lane padding)
            else:
                self.mesh = Mesh(marr.reshape(-1), axis_names=("dp",))
                self.tp = 1
                self.n_dev = marr.size
            self.device = marr.reshape(-1)[0]
            self._repl = NamedSharding(self.mesh, P())
            self._dp = lambda *rest: NamedSharding(self.mesh, P("dp", *rest))
        else:
            self.mesh = None
            self.tp = 1
            self.n_dev = 1
            self.device = device or jax.devices()[0]
        choices = platform_choices(self.device.platform)
        self.aes_gn = choices["aes_gn"]
        self.min_lanes = choices["min_lanes"]
        # σ gather table = H plus one all-zero row at index n_bits:
        # masked-out draws gather the zero row, so the XOR accumulation
        # needs no select.
        if pk.H is not None:
            mw = pk.H.shape[1]
            self.Hx_dev = self._put_H(
                np.concatenate(
                    [pk.H, np.zeros((1, mw), dtype=pk.H.dtype)])
            )
        else:
            self.Hx_dev = None
        if sk is not None:
            s32 = sk.s_words32().reshape(-1)
            # LPN-tp: the secret lives sharded P('tp') so the PRF
            # contraction — the hottest HBM read (SURVEY §6) — splits
            # tp-ways in the real prf program (see _prf_fn).  The guard is
            # on s_words64 (u64 words), not the flat u32 count: each rank's
            # slice must hold whole (lo, hi) u64 pairs, or the contraction
            # would misalign pairs and silently drop secret words.
            self._s32_tp = (self.tp > 1
                            and self.prm.s_words64 % self.tp == 0)
            if self._s32_tp:
                self.s32_dev = jax.device_put(
                    s32, NamedSharding(self.mesh, P("tp")))
            else:
                self.s32_dev = self._put_repl(s32)
        else:
            self.s32_dev = None
            self._s32_tp = False
        self._canon2 = self._put_repl(
            np.array(
                [pk.canon_tag & 0xFFFFFFFF, (pk.canon_tag >> 32) & 0xFFFFFFFF],
                dtype=U32,
            )
        )
        self._prf_fn_cache = {}
        self._sigma_fn_cache = {}
        self._mulgrid = None
        # σ dispatch pipeline: a bounded queue of in-flight chunk handles.
        # Chunks queue freely up to SIGMA_QUEUE_DEPTH and the throttle
        # waits on the OLDEST outstanding chunk only, so the host never
        # syncs once per chunk; the bound caps the device memory pinned by
        # in-flight σ outputs.
        self._sigma_queue = []
        # σ chunk failures observed by the pacing throttle: the op that
        # dispatched the chunk has already returned a Cipher, so the
        # failure is recorded here and re-raised at the next drain()
        # (every benchmark window and materialization barrier) instead of
        # being lost as a warning in a long run.
        self._sigma_failures: list[Exception] = []

    # ------------------------------------------------------------------
    # placement helpers (single-device vs dp mesh)
    # ------------------------------------------------------------------

    def _put_repl(self, arr):
        """Device-put with full replication (mesh) / plain put (1 device)."""
        if self.mesh is not None:
            return jax.device_put(arr, self._repl)
        return jax.device_put(arr, self.device)

    def _put_H(self, arr):
        """H placement: column-sharded over the tp axis when one exists
        (each chip holds m_bits/tp of every row), replicated otherwise."""
        if self.mesh is not None and self.tp > 1:
            return jax.device_put(
                arr, NamedSharding(self.mesh, P(None, "tp")))
        return self._put_repl(arr)

    @property
    def H_dev(self):
        """Routing flag kept for callers that check device-σ availability
        (matrix.sigma_words_start); the gather table subsumes H."""
        return self.Hx_dev

    @property
    def _wsp(self):
        """σ word-axis partition: 'tp' on a 2-D mesh, else unsharded."""
        return "tp" if self.tp > 1 else None

    def _jit(self, fn, in_specs=None, out_specs=None):
        """jit pinned to the engine's device, or GSPMD-sharded over the dp
        mesh when one is attached (in/out_specs are PartitionSpecs)."""
        if self.mesh is None:
            # jax.default_device (not the deprecated jit(device=...) arg
            # and its legacy lowering path) pins uncommitted inputs and
            # execution to the engine's device.
            jfn = jax.jit(fn)
            dev = self.device

            def call(*args):
                with jax.default_device(dev):
                    return jfn(*args)

            call.lower = jfn.lower  # ahead-of-time compile, as jax.jit has
            return call

        def ns(sp):
            # PartitionSpec subclasses tuple — check it before containers
            if isinstance(sp, P):
                return NamedSharding(self.mesh, sp)
            return tuple(ns(s) for s in sp)

        return jax.jit(fn, in_shardings=ns(in_specs), out_shardings=ns(out_specs))

    def _pad_lanes(self, n: int) -> int:
        """Lane padding: pow2 and at least the platform's min_lanes, and in
        mesh mode a multiple of 32*n_dev so the lane-packed [1920, n/32]
        AES mask layout splits evenly."""
        return _pad_pow2(n, lo=max(self.min_lanes,
                                   32 * _pad_pow2(self.n_dev, 1)))

    @property
    def mulgrid(self):
        """Dense-grid ct_mul program cache (parallel/mulgrid.py), lazy.

        In mesh mode the grid's independent layer blocks round-robin over
        every mesh device (block outputs are disjoint — no collectives)."""
        if self._mulgrid is None:
            from .mulgrid import MulGrid

            devs = (list(np.asarray(self.mesh.devices).reshape(-1))
                    if self.mesh is not None else [self.device])
            self._mulgrid = MulGrid(self.prm, devs)
        return self._mulgrid

    # ------------------------------------------------------------------
    # prf_R cores
    # ------------------------------------------------------------------

    def _prf_fn(self, n_pad: int):
        fn = self._prf_fn_cache.get(n_pad)
        if fn is not None:
            return fn
        # key planes [1920, n/32] shard over their lane-word columns
        kspec = P(None, "dp")
        specs = (kspec, P("dp"), P("dp"), kspec, P("dp"), P("dp"))
        if self.mesh is not None and self._s32_tp:
            # Real-ops LPN-tp: shard_map over (dp, tp) with the secret
            # sharded P('tp'); each rank ANDs its word slice of every
            # sample row and partial parities combine with one psum
            # (lpn.cores_from_streams_tp; pattern proven in sharding.py).
            nloc = n_pad // self.n_dev
            body = prf_program(self.prm, nloc, tp_axis="tp",
                               aes_gn=self.aes_gn)
            fn = jax.jit(jax.shard_map(
                body, mesh=self.mesh,
                in_specs=specs + (P("tp"),),
                out_specs=(P("dp", None), P("dp")),
                check_vma=False,
            ))
        else:
            fn = self._jit(
                prf_program(self.prm, n_pad, aes_gn=self.aes_gn),
                in_specs=specs + (P(),),
                out_specs=(P("dp", None), P("dp")),
            )
        self._prf_fn_cache[n_pad] = fn
        return fn

    # Lanes per compiled PRF program.
    PRF_CHUNK = 2048

    def prf_cores_async(self, keys: np.ndarray, nonces: np.ndarray,
                        toep_keys: np.ndarray, toep_nonces: np.ndarray):
        """[N,32] u8 keys + [N] u64 nonces (x2 for toep) -> (limbs [N,4],
        rej [N] bool), both device-resident jax arrays.

        Chunked like sigma(): all chunk programs are dispatched without an
        intervening sync; the caller fetches when it needs the values.
        """
        N = keys.shape[0]
        C = self.PRF_CHUNK * self.n_dev
        if N > C:
            rs, rejs = [], []
            for off in range(0, N, C):
                r, rej = self._prf_chunk(
                    keys[off : off + C], nonces[off : off + C],
                    toep_keys[off : off + C], toep_nonces[off : off + C],
                )
                rs.append(r)
                rejs.append(rej)
            return jnp.concatenate(rs), jnp.concatenate(rejs)
        return self._prf_chunk(keys, nonces, toep_keys, toep_nonces)

    def prf_cores(self, keys: np.ndarray, nonces: np.ndarray,
                  toep_keys: np.ndarray, toep_nonces: np.ndarray):
        """Synchronous prf_cores_async -> (numpy limbs, numpy rej)."""
        r, rej = self.prf_cores_async(keys, nonces, toep_keys, toep_nonces)
        return np.asarray(r), np.asarray(rej)

    def _prf_chunk(self, keys, nonces, toep_keys, toep_nonces):
        """One padded chunk -> device-resident (limbs, rej); no host sync."""
        N = keys.shape[0]
        n_pad, args = self.prf_key_args(keys, nonces, toep_keys, toep_nonces)
        r, rej = self._prf_fn(n_pad)(*args)
        return r[:N], rej[:N]

    def prf_key_args(self, keys, nonces, toep_keys, toep_nonces):
        """(n_pad, arguments) of the PRF program for one chunk: the keys
        expanded on the host into packed round-key planes, lanes padded."""
        N = keys.shape[0]
        n_pad = self._pad_lanes(N)

        def prep(kb, nn):
            kb_p = np.zeros((n_pad, 32), dtype=np.uint8)
            kb_p[:N] = kb
            nlo = np.zeros(n_pad, dtype=U32)
            nhi = np.zeros(n_pad, dtype=U32)
            nlo[:N] = (nn & np.uint64(0xFFFFFFFF)).astype(U32)
            nhi[:N] = (nn >> np.uint64(32)).astype(U32)
            return aesv.expand_keys_packed(kb_p), nlo, nhi

        rk, nlo, nhi = prep(keys, nonces)
        trk, tnlo, tnhi = prep(toep_keys, toep_nonces)
        return n_pad, (rk, nlo, nhi, trk, tnlo, tnhi, self.s32_dev)

    # ------------------------------------------------------------------
    # σ generation
    # ------------------------------------------------------------------

    def _sigma_fn(self, n_pad: int):
        fn = self._sigma_fn_cache.get(n_pad)
        if fn is not None:
            return fn
        prm = self.prm

        def run(Hx, lanes):
            return self._sigma_from_lanes(Hx, lanes, prm)

        fn = self._jit(
            run,
            in_specs=(P(None, self._wsp), P("dp", None, None)),
            out_specs=(P("dp", self._wsp), P("dp")),
        )
        self._sigma_fn_cache[n_pad] = fn
        return fn

    @staticmethod
    def _sigma_from_lanes(Hx, lanes, prm):
        # Hx = the gather table (see __init__): H columns, then an all-zero
        # row at index n_bits (masked-out draws land there, so the XOR
        # accumulation needs no select).
        cvals, ctake, fb1 = shactr.draws_and_take(
            prm.x_col_wt, prm.n_bits, "pvac.dom.x_seed", lanes)
        nvals, ntake, fb2 = shactr.draws_and_take(
            prm.err_wt, prm.m_bits, "pvac.dom.noise", lanes)
        # XOR of the selected H columns, order-free: thin gathers over all
        # D draws with non-selected draws redirected to the zero row.
        idx = jnp.where(ctake, cvals, np.int32(prm.n_bits))
        sig = Hx[idx[:, 0]]
        for j in range(1, idx.shape[1]):
            sig = sig ^ Hx[idx[:, j]]
        # noise bits via one-hot accumulation (selected values are unique
        # -> bits disjoint -> sum == xor)
        word = nvals // 32                      # [N, D]
        bit = (nvals % 32).astype(U32)
        masks = jnp.where(ntake, (U32(1) << bit).astype(U32), U32(0))
        hit = (word[:, :, None]
               == jnp.arange(prm.sigma_words32, dtype=np.int32)[None, None, :])
        contrib = jnp.where(hit, masks[:, :, None], U32(0)).sum(
            axis=1, dtype=U32
        )
        return sig ^ contrib, fb1 | fb2

    def _sigma_compact_fn(self, n_pad: int, u_pad: int):
        """Compact-transfer σ program: per-edge data arrives as one packed
        u32 (layer-slot<<11 | idx<<1 | ch) plus a u64 salt, and per-layer
        seeds as a [U, 3, 2] u32 table: ~12 B/edge of host-to-device
        transfer instead of 56 B/edge of expanded lane words.  Lane expansion (layer
        gather + field stacking) happens on device."""
        key = (n_pad, u_pad)
        fn = self._sigma_fn_cache.get(key)
        if fn is not None:
            return fn
        prm = self.prm

        def run(Hx, canon2, ltab, buf):
            # buf: [E, 3] u32 = (packed, salt_lo, salt_hi); canon2 [2] u32.
            # canon_tag is an INPUT, not a closure constant — baking it in
            # would give every keypair a different HLO and defeat the
            # persistent compile cache across keygens.
            E = buf.shape[0]
            packed = buf[:, 0]
            lid = (packed >> U32(11)).astype(np.int32)
            idx = (packed >> U32(1)) & U32(0x3FF)
            ch = packed & U32(1)
            zero = jnp.zeros((E,), dtype=jnp.uint32)
            seeds = ltab[lid]  # [E, 3, 2]
            lanes = jnp.stack(
                [
                    jnp.broadcast_to(canon2[None, :], (E, 2)),
                    seeds[:, 0], seeds[:, 1], seeds[:, 2],
                    jnp.stack([idx, zero], -1),
                    jnp.stack([ch, zero], -1),
                    buf[:, 1:3],
                ],
                axis=1,
            )  # [E, 7, 2]
            return self._sigma_from_lanes(Hx, lanes, prm)

        fn = self._jit(
            run,
            in_specs=(P(None, self._wsp), P(None), P(None, None, None),
                      P("dp", None)),
            out_specs=(P("dp", self._wsp), P("dp")),
        )
        self._sigma_fn_cache[key] = fn
        return fn

    SIGMA_CHUNK = 16384

    def compact_sigma_inputs(self, words: np.ndarray, tab=None):
        """The compact transfer form of σ lanes, or None where it does not
        apply: ``(ltab [u_pad, 3, 2] u32 device array, u_pad, buf [E, 3]
        u32)``.  The (ztag, nonce_lo, nonce_hi) triple is per-layer (few
        distinct values per batch), so the deduplicated seed table ships
        once and each edge carries one packed u32 and a u64 salt."""
        E = words.shape[0]
        if not (
            E > 0
            and (words[:, 0] == np.uint64(self.pk.canon_tag)).all()
            and (words[:, 4] < np.uint64(1024)).all()
            and (words[:, 5] < np.uint64(2)).all()
        ):
            return None
        if tab is not None:
            # caller supplied the (layer seed table, per-edge row) pair
            # it already owns — skip the structured-sort dedup, the
            # single biggest host cost of a warm dispatch
            trips = np.ascontiguousarray(tab[0], dtype=np.uint64)
            lid = np.asarray(tab[1])
        else:
            trips, lid = np.unique(words[:, 1:4], axis=0,
                                   return_inverse=True)
            lid = lid.reshape(-1)  # numpy 2.0: [E, 1] for axis unique
        if trips.shape[0] >= (1 << 21):
            return None
        ltab = np.stack(
            [(trips & np.uint64(0xFFFFFFFF)).astype(U32),
             (trips >> np.uint64(32)).astype(U32)],
            axis=-1,
        )  # [U, 3, 2]
        # coarse padding grid: u_pad only grows in 8x steps so the
        # jit cache key (n_pad, u_pad) stays stable across batches
        u_pad = 128
        while u_pad < ltab.shape[0]:
            u_pad *= 8
        ltab_p = np.zeros((u_pad, 3, 2), dtype=U32)
        ltab_p[: ltab.shape[0]] = ltab
        buf = np.empty((E, 3), dtype=U32)
        buf[:, 0] = (
            (lid.astype(np.uint32) << U32(11))
            | (words[:, 4].astype(np.uint32) << U32(1))
            | words[:, 5].astype(np.uint32)
        )
        buf[:, 1] = (words[:, 6] & np.uint64(0xFFFFFFFF)).astype(U32)
        buf[:, 2] = (words[:, 6] >> np.uint64(32)).astype(U32)
        return self._put_repl(jnp.asarray(ltab_p)), u_pad, buf

    def sigma(self, words: np.ndarray, tab=None):
        """Chunked σ generation: big batches run as repeats of one compiled
        16384-lane program plus one pow2-padded remainder call, instead of
        padding the whole batch to the next power of two.

        All chunks are dispatched back-to-back with no host sync in between.

        Returns ``(sig, fb, rows)`` where sig/fb keep each chunk's PADDED
        lanes and ``rows`` (host int64 [E]) indexes the valid lanes.  The
        padding is deliberately NOT sliced off on device: edge counts
        jitter batch to batch, so a device-side ``[:E]`` slice would
        compile a fresh tiny XLA program for every novel E.
        Consumers gather ``rows`` host-side at materialization instead.
        """
        E = words.shape[0]
        C = self.SIGMA_CHUNK * self.n_dev
        if E == 0:
            mw = self.prm.sigma_words32
            return (np.zeros((0, mw), dtype=U32), np.zeros(0, dtype=bool),
                    np.zeros(0, dtype=np.int64))

        compact = self.compact_sigma_inputs(words, tab)
        sigs = []
        fbs = []
        row_parts = []
        pad_off = 0
        for off in range(0, E, C):
            self._throttle()
            n_valid = min(C, E - off)
            if compact is not None:
                ltab_dev, u_pad, buf = compact
                s, f = self._sigma_compact_padded(
                    ltab_dev, u_pad, buf[off : off + C]
                )
            else:
                s, f = self._sigma_padded(words[off : off + C])
            sigs.append(s)
            fbs.append(f)
            row_parts.append(pad_off + np.arange(n_valid, dtype=np.int64))
            pad_off += int(s.shape[0])
            self._sigma_queue.append(f[:1])
        sig = sigs[0] if len(sigs) == 1 else jnp.concatenate(sigs, axis=0)
        fb = fbs[0] if len(fbs) == 1 else jnp.concatenate(fbs, axis=0)
        rows = (row_parts[0] if len(row_parts) == 1
                else np.concatenate(row_parts))
        return sig, fb, rows  # device-resident; callers fetch when needed

    # In-flight σ chunk bound (~16 MB device output per 16K-edge chunk at
    # default Params -> a ~768 MB ceiling): deep enough that a ct_mul
    # batch of 512 pairs (38 chunks) dispatches without stalling.
    SIGMA_QUEUE_DEPTH = 48

    def drain(self) -> None:
        """Wait for every queued σ chunk (the queue is in-order, so waiting
        on the newest completes them all).  Benchmarks call this so a timed
        window cannot hide still-in-flight σ work.  Re-raises any chunk
        failure the pacing throttle observed since the last drain — chunk
        programs are independent, so a dead chunk does NOT fail the newest
        handle and would otherwise vanish into a warning."""
        if self._sigma_queue:
            last = self._sigma_queue[-1]
            self._sigma_queue.clear()
            np.asarray(last)
        if self._sigma_failures:
            errs, self._sigma_failures = self._sigma_failures, []
            raise RuntimeError(
                f"{len(errs)} queued sigma chunk(s) failed since the last "
                f"drain; first failure: {errs[0]!r}"
            ) from errs[0]

    def _throttle(self) -> None:
        """Bound the σ dispatch queue: wait on the OLDEST outstanding chunk
        (never the newest — that would drain the whole in-order queue and
        cost one host sync per chunk)."""
        while len(self._sigma_queue) >= self.SIGMA_QUEUE_DEPTH:
            old = self._sigma_queue.pop(0)
            try:
                np.asarray(old)
            except Exception as e:  # noqa: BLE001
                # The throttle fetch is advisory (its only job is pacing),
                # but a failure here usually means that σ chunk's program
                # died.  Record it for the next drain() to re-raise (the
                # dispatching op has already returned its Cipher) and warn
                # immediately so the trace isn't lost if nobody drains.
                import warnings

                self._sigma_failures.append(e)
                warnings.warn(
                    f"queued sigma chunk failed during throttle wait "
                    f"(will re-raise at drain): {e!r}",
                    RuntimeWarning, stacklevel=2,
                )

    def _sigma_compact_padded(self, ltab_dev, u_pad: int, buf: np.ndarray):
        """One padded chunk -> PADDED (sig [n_pad, mw], fb [n_pad]); valid
        lanes are the first buf.shape[0] (no device-side slice — see
        :meth:`sigma`)."""
        E = buf.shape[0]
        n_pad = self._pad_lanes(E)
        bp = buf
        if n_pad != E:
            bp = np.zeros((n_pad, 3), dtype=U32)
            bp[:E] = buf
        return self._sigma_compact_fn(n_pad, u_pad)(
            self.Hx_dev, self._canon2, ltab_dev, jnp.asarray(bp)
        )

    def _sigma_padded(self, words: np.ndarray):
        """words [E, 7] uint64 (σ stream fields) -> PADDED (σ [n_pad, mw]
        uint32, fallback [n_pad] bool), both device-resident jax arrays
        (no host sync, no device-side slice — see :meth:`sigma`).

        σ stays on the accelerator; consumers that need host bytes
        (serialization, edge compaction) convert lazily.  Decryption and
        further homomorphic ops never read σ on the host, so op chains
        avoid the device->host transfer entirely.
        """
        E = words.shape[0]
        n_pad = self._pad_lanes(E)
        wp = np.zeros((n_pad, 7), dtype=np.uint64)
        wp[:E] = words
        lanes = np.stack(
            [(wp & np.uint64(0xFFFFFFFF)).astype(U32),
             (wp >> np.uint64(32)).astype(U32)],
            axis=-1,
        )
        return self._sigma_fn(n_pad)(self.Hx_dev, jnp.asarray(lanes))


def enable_device(pk: PubKey, sk: SecKey | None = None, device=None,
                  mesh: Mesh | None = None) -> DeviceEngine:
    """Attach a DeviceEngine to pk; ops route hot kernels through it.

    Pass ``mesh`` to run every engine program sharded over the mesh's
    devices (data-parallel over lanes/edges, key material replicated)."""
    eng = DeviceEngine(pk, sk, device, mesh=mesh)
    pk._engine = eng
    return eng


def disable_device(pk: PubKey) -> None:
    if hasattr(pk, "_engine"):
        del pk._engine
