"""Morton (z-order) encode/decode + occupancy bitfield packing in jnp.

Functional equivalents of the reference CUDA utilities
(``raymarching.cu:183-330``: ``morton3D``, ``morton3D_invert``, ``packbits``)
used by its occupancy-grid machinery. Here the occupancy grid is stored as
a dense float array, and the Morton utilities are provided for layout
parity and tooling.
"""

from __future__ import annotations

import jax.numpy as jnp


def _expand_bits_3(v):
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.astype(jnp.uint32) & jnp.uint32(0x3FF)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(xyz):
    """[N, 3] int coords (< 1024) -> [N] Morton codes."""
    x = _expand_bits_3(xyz[..., 0])
    y = _expand_bits_3(xyz[..., 1])
    z = _expand_bits_3(xyz[..., 2])
    return (x | (y << 1) | (z << 2)).astype(jnp.uint32)


def _compact_bits_3(v):
    v = v.astype(jnp.uint32) & jnp.uint32(0x49249249)
    v = (v | (v >> 2)) & jnp.uint32(0xC30C30C3)
    v = (v | (v >> 4)) & jnp.uint32(0x0F00F00F)
    v = (v | (v >> 8)) & jnp.uint32(0xFF0000FF)
    v = (v | (v >> 16)) & jnp.uint32(0x000003FF)
    return v


def morton3d_invert(codes):
    """[N] Morton codes -> [N, 3] int coords."""
    x = _compact_bits_3(codes)
    y = _compact_bits_3(codes >> 1)
    z = _compact_bits_3(codes >> 2)
    return jnp.stack([x, y, z], axis=-1).astype(jnp.int32)


def packbits(density, thresh):
    """Density grid [..., 8k] -> packed uint8 bitfield [..., k]
    (``raymarching.cu:237-268`` semantics)."""
    occ = (density > thresh).astype(jnp.uint8)
    flat = occ.reshape(*occ.shape[:-1], -1, 8)
    weights = (1 << jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(flat * weights, axis=-1).astype(jnp.uint8)
