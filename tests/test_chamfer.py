"""Chamfer op tests vs a scipy cKDTree reference (mirrors the reference's own
KDTree cross-check in ``error_matrices.py:548-585``)."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

from nvsf_tpu.ops.chamfer import chamfer_distance, chamfer_loss, min_dist2


def _kdtree_chamfer(a, b):
    d1 = cKDTree(b).query(a)[0] ** 2
    d2 = cKDTree(a).query(b)[0] ** 2
    return d1, d2


def test_chamfer_matches_kdtree():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(257, 3)).astype(np.float32)
    b = rng.normal(size=(191, 3)).astype(np.float32)
    d1, d2 = chamfer_distance(jnp.asarray(a), jnp.asarray(b))
    r1, r2 = _kdtree_chamfer(a, b)
    np.testing.assert_allclose(np.asarray(d1), r1, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(d2), r2, rtol=1e-3, atol=1e-5)


def test_chamfer_blocked_matches_direct():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(100, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(1000, 3)), jnp.float32)
    direct = min_dist2(a, b, block_m=4096)
    blocked = min_dist2(a, b, block_m=128)
    np.testing.assert_allclose(np.asarray(direct), np.asarray(blocked),
                               rtol=1e-4, atol=1e-5)


def test_chamfer_masked():
    a = jnp.array([[0.0, 0, 0], [10.0, 0, 0]])
    b = jnp.array([[0.1, 0, 0], [99.0, 0, 0]])
    b_mask = jnp.array([True, False])  # far-away b point is padding
    d1, d2 = chamfer_distance(a, b, b_mask=b_mask)
    np.testing.assert_allclose(np.asarray(d1), [0.01, (10 - 0.1) ** 2],
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(d2), [0.01, 0.0], rtol=1e-4)


def test_chamfer_grad_matches_analytic():
    a = jnp.array([[0.0, 0.0, 0.0]])
    b = jnp.array([[1.0, 2.0, 2.0]])
    g = jax.grad(lambda x: chamfer_loss(x, b))(a)
    # loss = 0.5*(|a-b|^2 + |b-a|^2)/1 => d/da = 2(a-b)... times 0.5*2 = 2(a-b)*...
    # loss = |a-b|^2, grad = 2(a-b)
    np.testing.assert_allclose(np.asarray(g[0]), 2 * np.array([-1, -2, -2.0]),
                               rtol=1e-5)


def test_chamfer_loss_identical_clouds_zero():
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(64, 3)), jnp.float32)
    assert float(chamfer_loss(a, a)) == 0.0


def test_chamfer_world_scale_matches_float64_brute_force():
    """LiDAR-frame points in metres out to 80 m (as the eval meter feeds
    them) with 5 cm noise: float32 squared distances must hold to ~1e-5 m^2,
    far below the F@0.05 threshold of 2.5e-3 m^2 (plus float32 rounding of
    the large distances of unmatched points)."""
    rng = np.random.default_rng(3)
    n = 600
    r = rng.uniform(2.0, 80.0, n)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(-0.43, 0.03, n)
    b = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                  r * np.sin(el)], -1)
    a = b[:450] + rng.normal(0.0, 0.05, (450, 3))
    d1, d2 = chamfer_distance(jnp.asarray(a, jnp.float32),
                              jnp.asarray(b, jnp.float32), block_m=128)
    a32 = a.astype(np.float32).astype(np.float64)
    b32 = b.astype(np.float32).astype(np.float64)
    pair = ((a32[:, None] - b32[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(d1), pair.min(1), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(d2), pair.min(0), rtol=1e-6,
                               atol=1e-5)


def test_chamfer_loss_grad_matches_argmin_subgradient():
    """d/da of 0.5*(mean_i min_j |a_i-b_j|^2 + mean_j min_i |a_i-b_j|^2)
    routes 2(a-b) to each nearest pair, as the CUDA backward does."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(37, 3))
    b = rng.normal(size=(53, 3))
    g = np.asarray(jax.grad(lambda x: chamfer_loss(x, jnp.asarray(
        b, jnp.float32), block_m=16))(jnp.asarray(a, jnp.float32)))
    diff = a[:, None] - b[None]                          # [37, 53, 3]
    pair = (diff ** 2).sum(-1)
    ref = np.zeros_like(a)
    j = pair.argmin(1)
    ref += 0.5 * 2 * diff[np.arange(37), j] / 37
    i = pair.argmin(0)
    np.add.at(ref, i, 0.5 * 2 * diff[i, np.arange(53)] / 53)
    np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-6)
