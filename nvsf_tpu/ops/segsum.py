"""Segment accumulation for hash/plane table gradients.

``segment_add_fm(cols, vals, T)`` computes ``zeros([F, T]).at[:, cols].add(vals)``
— the backward of a features-major table gather. XLA lowers the scatter-add
to atomic adds on the GPU, the same mechanism tiny-cuda-nn's fused
hash-encoder backward uses (reference ``nerf/models/hash_field.py:108-133``
via tcnn). Sums are float32; the order of the atomic adds, and so the last
bits of a sum, varies from run to run.
"""

from __future__ import annotations

import jax.numpy as jnp


def segment_add_fm(cols: jnp.ndarray, vals: jnp.ndarray, T: int) -> jnp.ndarray:
    """Sum update rows into a features-major table.

    cols: [M] int32 in [0, T); vals: [F, M] -> [F, T] with
    ``out[:, t] = sum(vals[:, cols == t])``.
    """
    F = vals.shape[0]
    return jnp.zeros((F, T), vals.dtype).at[:, cols].add(vals)
