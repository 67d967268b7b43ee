"""pvac_hfhe_cppbyv_tpu — PVAC-HFHE on JAX/XLA.

A from-scratch JAX/XLA implementation of the PVAC-HFHE scheme over
F_p, p = 2^127 - 1 (reference: the header-only C++17 library
vasihh2009/pvac_hfhe_cppbyv, umbrella header include/pvac/pvac.hpp).  The
compute path — Mersenne-field limb arithmetic, AES-256-CTR PRF, LPN
sampling, GF(2) Toeplitz hashing, hypergraph syndrome construction — runs as
vectorized multi-limb kernels (numpy on host, jnp under XLA on the device), batched
over many ciphertexts and shardable over a device mesh; the host side keeps
the ciphertext graph, serialization and key management.

``import pvac_hfhe_cppbyv_tpu as pvac`` exposes the full public API
(mirrors include/pvac/pvac.hpp:4-23).
"""

PVAC_VERSION = "0.1.0"
# Reference library version constants (include/pvac/pvac.hpp:27-37).
PVAC_REF_VERSION = "0.1.0"

from .config import get_debug_level, set_debug_level
from .params import Params, params_from_json, params_to_json, small_test_params
from .core.field import (
    P, MASK63, fp_from_u64, fp_from_words, fp_to_words,
    fp_add, fp_sub, fp_neg, fp_mul, fp_inv, fp_pow, rand_fp_nonzero,
)
from .core import fieldv
from .core import bitvec
from .core.random import csprng_bytes, csprng_u64
from .core.hash import sha256, Shake256, XofShake
from .types import (
    Dom, RRULE_BASE, RRULE_PROD, SGN_P, SGN_M, sgn_val,
    Nonce128, make_nonce128, RSeed, Layer, Cipher, PubKey, SecKey, EvalKey, Ubk,
)
from .crypto.keygen import keygen, factor_small
from .crypto.lpn import (
    derive_aes_key, lpn_make_ybits, prf_R, prf_R_noise, prf_R_batch,
    fnv1a_domain, hash_to_fp_nonzero,
)
from .crypto.matrix import (
    prg_choose_k, gen_ubk_public, apply_perm_sigma, gen_H, prg_layer_ztag,
    sigma_from_H, ubk_apply,
)
from .ops.encrypt import (
    plan_noise, sigma_density, compact_edges, compact_layers, guard_budget,
    prf_noise_delta, enc_fp_depth, enc_fp_depth_batch, combine_ciphers,
    enc_value, enc_value_depth, enc_value_batch, enc_zero_depth,
)
from .ops.decrypt import dec_value, dec_value_batch, layer_R
from .ops.arithmetic import (
    ct_add, ct_sub, ct_neg, ct_scale, ct_mul, ct_mul_batch, ct_div_const,
    ct_add_batch, ct_sub_batch,
)
from .ops.recrypt import make_evalkey, ct_recrypt, sigma_needs_balance
from .ops.commit import commit_ct
from .utils.text import enc_text, dec_text, pack_15_bytes_to_fp, unpack_fp_to_15_bytes
from .utils.metrics import (
    dump_metrics, sigma_shannon, agg_layer_gsum, check_mul_gsum_all,
)
from .io.serial import (
    save_cts, load_cts, save_sk, load_sk, save_pk, load_pk,
    save_pklite, load_pklite, save_params, load_params,
    MAGIC_CT, MAGIC_SK, MAGIC_PK, VER,
)

from .service import Client, Evaluator

__all__ = [n for n in dir() if not n.startswith("_")]
