"""Device-mesh helpers.

The reference is single-threaded (SURVEY.md §2.3); parallelism here is
designed for a device mesh:

- ``dp`` (data parallel): independent ciphertexts / PRF lanes / edges —
  embarrassingly parallel, no collectives.
- ``tp`` (tensor parallel): intra-op sharding — σ-word columns, LPN row
  blocks, and ct_mul bucket partial sums reduced with ``psum`` over the device interconnect.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Split devices into (dp, tp): tp gets up to 4, dp the rest."""
    tp = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices >= cand:
            tp = cand
            break
    return n_devices // tp, tp


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = default_mesh_shape(n)
    dp, tp = shape
    assert dp * tp == n, f"mesh {shape} != {n} devices"
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))
