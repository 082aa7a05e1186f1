"""Host->device staging helpers.

A dtype-CONVERTING device put (``jnp.asarray(uint8_host, jnp.float32)``)
converts outside any jitted program; every host->device boundary here
therefore converts on host (numpy) first, or ships the raw dtype and
lets the consuming jit cast (fused for free).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def stage_f32(a) -> jax.Array:
    """Stage a host array as float32 with a same-dtype put; device
    arrays pass through untouched (a jit consumer casts if needed)."""
    if isinstance(a, jax.Array):
        return a
    return jnp.asarray(np.asarray(a, np.float32))


def stage_raw(a) -> jax.Array:
    """Stage a host array with a same-dtype put, PRESERVING uint8
    (4x fewer link bytes than f32; the consuming jit casts uint8->f32
    fused for free). Dtypes other than uint8/float32 convert to
    float32 on host first. Device arrays pass through untouched."""
    if isinstance(a, jax.Array):
        return a
    a = np.asarray(a)
    if a.dtype not in (np.uint8, np.float32):
        a = a.astype(np.float32)
    return jnp.asarray(a)
