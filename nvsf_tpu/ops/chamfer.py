"""Chamfer distance as a tiled nearest-neighbor reduction in XLA.

Replaces the reference's CUDA extension (``nvsf/nerf/chamfer3D/chamfer3D.cu``,
``dist_chamfer_3D.py:41-97``): squared-distance NN both ways. The pairwise
squared distance is summed directly over the 3 coordinates,
``(ax-bx)^2 + (ay-by)^2 + (az-bz)^2``: elementwise work that XLA fuses into
the min-reduction, with no cancellation. (The expansion
``|a|^2 + |b|^2 - 2 a.b`` loses metres^2 at 80 m when its matmul runs in
TF32, the GPU's default for float32 products.) The min-reduction streams
over blocks of the second cloud via ``lax.scan``, so memory stays
O(N * block) for arbitrarily large clouds. Gradients come free via
autodiff of the min (subgradient to the argmin), matching the CUDA
backward's +-2g(x1-x2) scatter.

Supports padded/masked clouds (fixed shapes for jit): masked-out points get
+inf as neighbors and zero as queries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = 1e10


def _pairwise_min_dist2(a, b, b_valid):
    """a: [N, 3], b: [M, 3] -> per-a min squared distance to valid b."""
    d2 = sum((a[:, None, k] - b[None, :, k]) ** 2 for k in range(3))
    d2 = jnp.where(b_valid[None, :], d2, _BIG)                # [N, M]
    return jnp.min(d2, axis=-1)


def min_dist2(a, b, b_mask=None, block_m: int = 4096):
    """For each point in ``a`` the squared distance to its NN in ``b``.

    Streams over ``b`` in blocks of ``block_m`` with a scan (O(N*block)
    memory). Shapes are static; ``b_mask`` marks valid rows of ``b``.
    """
    N = a.shape[0]
    M = b.shape[0]
    if b_mask is None:
        b_mask = jnp.ones((M,), bool)
    if M <= block_m:
        return _pairwise_min_dist2(a, b, b_mask)
    pad = (-M) % block_m
    b_p = jnp.pad(b, ((0, pad), (0, 0)))
    m_p = jnp.pad(b_mask, (0, pad))
    nb = (M + pad) // block_m
    b_blocks = b_p.reshape(nb, block_m, 3)
    m_blocks = m_p.reshape(nb, block_m)

    def step(carry, blk):
        bb, mb = blk
        d = _pairwise_min_dist2(a, bb, mb)
        return jnp.minimum(carry, d), None

    init = jnp.full((N,), _BIG, a.dtype)
    out, _ = jax.lax.scan(step, init, (b_blocks, m_blocks))
    return out


def chamfer_distance(a, b, a_mask=None, b_mask=None, block_m: int = 4096):
    """Bidirectional squared chamfer (``dist_chamfer_3D.py:90-97`` API).

    Returns (dist1 [N], dist2 [M]): dist1[i] = min_j |a_i - b_j|^2 over valid
    b, zeroed at invalid a (and vice versa). Callers aggregate — the
    reference uses ``(dist1 + dist2).mean() * 0.5`` (``trainer.py:232-233``).
    Serves both the training losses and the eval meter.
    """
    d1 = min_dist2(a, b, b_mask, block_m)
    d2 = min_dist2(b, a, a_mask, block_m)
    if a_mask is not None:
        d1 = jnp.where(a_mask, d1, 0.0)
    if b_mask is not None:
        d2 = jnp.where(b_mask, d2, 0.0)
    return d1, d2


def chamfer_loss(a, b, a_mask=None, b_mask=None, block_m: int = 4096):
    """Mean symmetric chamfer: ``(dist1 + dist2).mean() * 0.5`` with proper
    masked means."""
    d1, d2 = chamfer_distance(a, b, a_mask, b_mask, block_m)
    if a_mask is None:
        m1 = d1.mean()
    else:
        m1 = d1.sum() / jnp.maximum(a_mask.sum(), 1)
    if b_mask is None:
        m2 = d2.mean()
    else:
        m2 = d2.sum() / jnp.maximum(b_mask.sum(), 1)
    return 0.5 * (m1 + m2)
