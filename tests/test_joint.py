"""Cross-branch fusion equivalence: the joint LiDAR+camera density/render
path (one fused gather per encoder family, shared sigma-net batch —
``NVSFFieldSpec.density_joint`` / ``RendererSpec.run_joint``) must match
the separate per-branch paths exactly, forward AND gradient.

The reference renders the branches in separate calls
(``nvsf/nerf/trainer.py:193-200,491-499``); the fusion is a performance
redesign, so its contract is bit-level-comparable math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import flatten_util

from nvsf_tpu.models.field import NVSFFieldSpec
from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.render.renderer import RendererSpec

TINY = NVSFFieldSpec(min_resolution=8, n_levels_plane=2, base_resolution=16,
                     max_resolution=64, n_levels_hash=3,
                     n_features_per_level_hash=4, log2_hashmap_size=10,
                     flow_n_levels=3, flow_n_features_per_level=8,
                     flow_log2_hashmap_size=10, num_frames=6, bound=1.0)


def _points(n, key):
    return jax.random.uniform(key, (n, 3), minval=-1.0, maxval=1.0)


def test_density_joint_matches_separate():
    params = TINY.init(jax.random.PRNGKey(0))
    kl, kc, ke = jax.random.split(jax.random.PRNGKey(1), 3)
    x_l, x_c, xe = _points(40, kl), _points(24, kc), _points(16, ke)
    t = 0.37
    d_l = TINY.density(params, x_l, t, cal_lidar_color=True)
    d_c = TINY.density(params, x_c, t, cal_lidar_color=False)
    dj = TINY.density_joint(params, x_l, x_c, t, x_flow_extra=xe)
    np.testing.assert_allclose(dj["sigma_l"], d_l["sigma"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dj["sigma_c"], d_c["sigma"], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dj["geo_feat_l"], d_l["geo_feat"], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dj["geo_feat_c"], d_c["geo_feat"], rtol=2e-4,
                               atol=1e-5)
    fe = TINY.flow(params, xe, t)
    np.testing.assert_allclose(dj["flow_extra"]["flow_forward"],
                               fe["flow_forward"], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(dj["flow_extra"]["flow_backward"],
                               fe["flow_backward"], rtol=2e-5, atol=1e-7)


@pytest.mark.slow
def test_density_joint_gradients_match_separate():
    params = TINY.init(jax.random.PRNGKey(0))
    kl, kc = jax.random.split(jax.random.PRNGKey(2))
    x_l, x_c = _points(40, kl), _points(24, kc)
    t = 0.61

    def loss_sep(p):
        a = TINY.density(p, x_l, t, cal_lidar_color=True)
        b = TINY.density(p, x_c, t, cal_lidar_color=False)
        return (jnp.sum(a["sigma"]) + 2 * jnp.sum(b["sigma"])
                + jnp.sum(a["geo_feat"] ** 2) + jnp.sum(b["geo_feat"] ** 2))

    def loss_joint(p):
        d = TINY.density_joint(p, x_l, x_c, t)
        return (jnp.sum(d["sigma_l"]) + 2 * jnp.sum(d["sigma_c"])
                + jnp.sum(d["geo_feat_l"] ** 2)
                + jnp.sum(d["geo_feat_c"] ** 2))

    g1, _ = flatten_util.ravel_pytree(jax.grad(loss_sep)(params))
    g2, _ = flatten_util.ravel_pytree(jax.grad(loss_joint)(params))
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=5e-4,
                               atol=1e-5)


def _rays(n, key):
    ro = jnp.zeros((n, 3))
    rd = jax.random.normal(key, (n, 3))
    return ro, rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)


@pytest.mark.slow
def test_run_joint_matches_separate_dense():
    rend = RendererSpec(field=TINY, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=24,
                        active_sensor=True)
    params = TINY.init(jax.random.PRNGKey(0))
    kl, kc = jax.random.split(jax.random.PRNGKey(3))
    ro_l, rd_l = _rays(12, kl)
    ro_c, rd_c = _rays(8, kc)
    t = 0.5
    sep_l = rend.run(params, ro_l, rd_l, t, cal_lidar_color=True)
    sep_c = rend.run(params, ro_c, rd_c, t, cal_lidar_color=False,
                     bg_color=1.0)
    out_l, out_c, _ = rend.run_joint(params, ro_l, rd_l, ro_c, rd_c, t,
                                     bg_color=1.0)
    np.testing.assert_allclose(out_l["depth_lidar"], sep_l["depth_lidar"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out_l["image_lidar"], sep_l["image_lidar"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out_c["depth"], sep_c["depth"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(out_c["image"], sep_c["image"], rtol=1e-4,
                               atol=1e-6)


@pytest.mark.slow
def test_run_joint_matches_separate_occupancy():
    rend = RendererSpec(field=TINY, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=32,
                        active_sensor=True)
    params = TINY.init(jax.random.PRNGKey(0))
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    # a non-trivial grid: half the cells occupied
    key = jax.random.PRNGKey(7)
    grid_l = jnp.where(jax.random.uniform(key, (8, 8, 8)) > 0.5, 10.0, 0.0)
    grid_c = jnp.where(jax.random.uniform(key, (8, 8, 8)) > 0.3, 10.0, 0.0)
    kl, kc = jax.random.split(jax.random.PRNGKey(4))
    ro_l, rd_l = _rays(12, kl)
    ro_c, rd_c = _rays(8, kc)
    t = 0.25
    sep_l = rend.run_occupancy(params, ro_l, rd_l, t, spec, grid_l,
                               num_steps_occ=16, cal_lidar_color=True,
                               occ_thresh=1.0)
    sep_c = rend.run_occupancy(params, ro_c, rd_c, t, spec, grid_c,
                               num_steps_occ=16, cal_lidar_color=False,
                               bg_color=1.0, occ_thresh=1.0)
    out_l, out_c, _ = rend.run_joint(
        params, ro_l, rd_l, ro_c, rd_c, t, bg_color=1.0, occ_spec=spec,
        occ_grid_l=grid_l, occ_grid_c=grid_c, num_steps_occ=16,
        occ_thresh=1.0)
    np.testing.assert_allclose(out_l["depth_lidar"], sep_l["depth_lidar"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out_c["depth"], sep_c["depth"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(out_c["image"], sep_c["image"], rtol=1e-4,
                               atol=1e-6)


def test_joint_fusion_guards_incompatible_configs(tmp_path):
    """The experimental fused path cannot honor per-branch K or
    remat_chunks; the Trainer must refuse rather than silently diverge
    from the default separate path."""
    from nvsf_tpu.data.synthetic import make_synthetic_scene
    from nvsf_tpu.train.trainer import Trainer
    from test_trainer import SCENE_SPEC, tiny_config

    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    with pytest.raises(ValueError, match="num_steps_occ_rgb"):
        Trainer(tiny_config(enable_rgb=True, joint_fusion=True,
                            render_mode="occupancy", num_steps_occ=16,
                            num_steps_occ_rgb=32, occ_grid_size=16),
                scene, workspace=str(tmp_path))
    with pytest.raises(ValueError, match="remat_chunks"):
        Trainer(tiny_config(enable_rgb=True, joint_fusion=True,
                            remat_chunks=4),
                scene, workspace=str(tmp_path))
