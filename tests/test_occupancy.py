"""Occupancy-grid renderer tests: morton utils, compaction correctness,
occupancy-mode training equivalence & convergence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvsf_tpu.ops.morton import morton3d, morton3d_invert, packbits
from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene
from nvsf_tpu.train.trainer import Trainer

from test_trainer import SCENE_SPEC, tiny_config


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    xyz = jnp.asarray(rng.integers(0, 1024, (256, 3)), jnp.int32)
    codes = morton3d(xyz)
    back = morton3d_invert(codes)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(xyz))
    # morton code of (1,0,0) is 1, (0,1,0) is 2, (0,0,1) is 4
    np.testing.assert_array_equal(
        np.asarray(morton3d(jnp.eye(3, dtype=jnp.int32))), [1, 2, 4])


def test_packbits():
    dens = jnp.asarray(np.arange(16, dtype=np.float32))
    packed = packbits(dens, thresh=7.5)  # first 8 below, last 8 above
    np.testing.assert_array_equal(np.asarray(packed), [0, 255])


def test_compaction_selects_occupied_strided():
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = jnp.zeros((8, 8, 8))
    # occupy the slab x in [0.25, 0.5) -> cells ix = 5
    grid = grid.at[5].set(10.0)
    o = jnp.zeros((1, 3))
    d = jnp.array([[1.0, 0.0, 0.0]])
    z = jnp.linspace(0.01, 0.99, 64)[None, :]
    z_sel, valid = spec.compact_samples(grid, o, d, z, K=8, thresh=1.0)
    z_sel, valid = np.asarray(z_sel)[0], np.asarray(valid)[0]
    inside = (z_sel >= 0.24) & (z_sel < 0.51)
    assert inside[valid].all()
    assert valid.sum() == 8  # slab spans ~16 candidates; 8 strided kept
    assert np.all(np.diff(z_sel[valid]) >= 0)  # ascending
    # strided selection covers the whole slab, not just its near edge
    assert z_sel[valid].max() > 0.4


def test_compaction_fewer_than_k():
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = jnp.zeros((8, 8, 8)).at[5].set(10.0)
    o = jnp.zeros((1, 3))
    d = jnp.array([[1.0, 0.0, 0.0]])
    z = jnp.linspace(0.01, 0.99, 16)[None, :]  # ~4 candidates in the slab
    z_sel, valid = spec.compact_samples(grid, o, d, z, K=8, thresh=1.0)
    v = np.asarray(valid)[0]
    assert 0 < v.sum() < 8
    zs = np.asarray(z_sel)[0]
    assert ((zs[v] >= 0.24) & (zs[v] < 0.51)).all()


def test_stratified_jitter_covers_comb_gaps():
    """With an uncarved grid, compaction picks an evenly-strided comb of
    radii shared by every constant-near/far LiDAR ray; the post-compaction
    stratified jitter must spread samples over the WHOLE inter-comb gap
    (the round-4 production fog-collapse mechanism), stay ascending, and
    stay within the selected span."""
    from nvsf_tpu.render.renderer import stratified_segment_jitter
    T, K = 64, 8
    near, far = 0.1, 0.9
    z_cand = jnp.linspace(near, far, T)[None, :]
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = spec.init()                       # fully occupied -> stride 8
    o = jnp.zeros((1, 3))
    d = jnp.array([[1.0, 0.0, 0.0]])
    z_sel, valid = spec.compact_samples(grid, o, d, z_cand, K=K, thresh=0.01)
    assert np.asarray(valid).all()
    sdv = (far - near) / T
    sd = jnp.full((1, 1), sdv)
    z0 = np.asarray(z_sel)[0]
    zs = []
    for i in range(200):
        zj = stratified_segment_jitter(jax.random.PRNGKey(i), z_sel, sd,
                                       T, K)
        zj = np.asarray(zj)[0]
        assert np.all(np.diff(zj) >= 0)              # ascending
        assert zj.min() >= z0[0] - 0.5 * sdv - 1e-6  # in the padded span
        assert zj.max() <= z0[-1] + 0.5 * sdv + 1e-6
        zs.append(zj)
    zs = np.concatenate(zs)
    # coverage: every dense candidate bin between the first and last comb
    # point receives samples (the old +-0.5*sd jitter left 7/8 empty)
    hist, _ = np.histogram(zs, bins=T - K, range=(z0[0], z0[-1]))
    assert (hist > 0).all(), hist
    # interior samples are expectation-centered on their comb point;
    # boundary samples shift inward by (w_r - w_l)/2 <= half the stride
    mean = np.stack(np.split(zs, 200)).mean(axis=0)
    np.testing.assert_allclose(mean[1:-1], z0[1:-1], atol=sdv * 8 * 0.15)
    np.testing.assert_allclose(mean[[0, -1]], z0[[0, -1]],
                               atol=sdv * 8 * 0.5)


def test_occupancy_grid_update_clears_empty_space():
    spec = OccupancyGridSpec(grid_size=16, bound=1.0, decay=0.5,
                             update_fraction=1)
    grid = spec.init()
    # field: dense only where x > 0
    def density_fn(p):
        return jnp.where(p[:, 0] > 0, 100.0, 0.0)
    key = jax.random.PRNGKey(0)
    for i in range(25):
        key, k = jax.random.split(key)
        grid = spec.update(grid, k, density_fn, thresh=1.0)
    g = np.asarray(grid)
    # cells are sampled with replacement; a long run clears nearly all
    assert (g[:7] < 1.0).mean() > 0.95     # empty half decayed below thresh
    assert (g[9:] > 1.0).all()             # occupied half refreshed


@pytest.mark.slow
def test_occupancy_training_converges(tmp_path):
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    tr = Trainer(tiny_config(render_mode="occupancy", num_steps=96,
                             num_steps_occ=32, occ_grid_size=32,
                             occ_update_interval=4,
                             change_patch_size_lidar=[1]),
                 scene, workspace=str(tmp_path))
    losses = []
    for ep in range(1, 9):
        tr.epoch = ep
        losses.append(tr.train_one_epoch(order=np.arange(len(scene))).loss)
    assert losses[-1] < 0.7 * losses[0], losses
    # grid evolved away from its init (density refresh is running); actual
    # emptiness takes more epochs than a unit test can afford
    # with update_fraction=16 and 12 refreshes, ~1-(1-1/16)^12 = 54% of
    # cells get touched in expectation
    g = np.asarray(tr.state["occ_grid_lidar"])
    assert (g != 32.0).mean() > 0.3


def test_occupancy_matches_dense_when_fully_occupied(tmp_path):
    """With a fully-occupied grid and K == T the occupancy path must equal
    dense rendering."""
    from nvsf_tpu.render.renderer import RendererSpec
    from test_renderer import TINY_FIELD
    rend = RendererSpec(field=TINY_FIELD, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=32)
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = spec.init()
    params = TINY_FIELD.init(jax.random.PRNGKey(0))
    o = jnp.zeros((8, 3))
    d = jax.random.normal(jax.random.PRNGKey(1), (8, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    dense = rend.run(params, o, d, 0.5, cal_lidar_color=True)
    occ = rend.run_occupancy(params, o, d, 0.5, spec, grid,
                             num_steps_occ=32, cal_lidar_color=True)
    np.testing.assert_allclose(np.asarray(occ["depth_lidar"]),
                               np.asarray(dense["depth_lidar"]),
                               rtol=1e-4, atol=1e-6)


def test_stream_slab_non_multiple_keeps_all_samples():
    """run_occupancy_stream with K not a multiple of ``slab`` must composite
    ALL K samples (regression: the while_loop ran floor(K/S) slabs, silently
    dropping the last K % S samples — and because compaction strides across
    the occupied span, that cut the far tail of every ray)."""
    from nvsf_tpu.render.renderer import RendererSpec
    from test_renderer import TINY_FIELD
    rend = RendererSpec(field=TINY_FIELD, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=48)
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = spec.init()  # fully occupied
    params = TINY_FIELD.init(jax.random.PRNGKey(0))
    o = jnp.zeros((8, 3))
    d = jax.random.normal(jax.random.PRNGKey(1), (8, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(num_steps_occ=24, cal_lidar_color=True, trans_eps=0.0)
    r16 = rend.run_occupancy_stream(params, o, d, 0.5, spec, grid,
                                    slab=16, **kw)
    r8 = rend.run_occupancy_stream(params, o, d, 0.5, spec, grid,
                                   slab=8, **kw)
    np.testing.assert_allclose(np.asarray(r16["depth_lidar"]),
                               np.asarray(r8["depth_lidar"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(r16["image_lidar"]),
                               np.asarray(r8["image_lidar"]),
                               rtol=1e-5, atol=1e-7)


def test_render_k_knob_routes_lidar_only(tmp_path):
    """num_steps_occ_render must apply to LiDAR render kwargs only; camera
    renders keep the training K (RGB pays ~1.7dB per K step down)."""
    from test_trainer import SCENE_SPEC, tiny_config
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    cfg = tiny_config(render_mode="occupancy", num_steps_occ=16,
                      num_steps_occ_render=8, occ_grid_size=8)
    tr = Trainer(cfg, scene, workspace=str(tmp_path), seed=0)
    grid = tr.state["occ_grid_lidar"]
    assert tr._occ_kwargs(grid, lidar=True)["num_steps_occ"] == 8
    assert tr._occ_kwargs(grid)["num_steps_occ"] == 16
    # default 0 -> fall through to the training K
    cfg0 = tiny_config(render_mode="occupancy", num_steps_occ=16,
                       occ_grid_size=8)
    tr0 = Trainer(cfg0, scene, workspace=str(tmp_path), seed=0)
    g0 = tr0.state["occ_grid_lidar"]
    assert tr0._occ_kwargs(g0, lidar=True)["num_steps_occ"] == 16


def test_occupancy_retention_moving_object():
    """A FAST-moving object's trajectory cells must stay occupied under the
    stratified-time union refresh (a times[0]-only refresh
    silently culls dynamic content)."""
    spec = OccupancyGridSpec(grid_size=16, bound=1.0, decay=0.8,
                             update_fraction=1)
    grid = spec.init()

    # blob of radius 0.12 sweeping x from -0.8 to 0.8 over t in [0, 1]:
    # each cell on the trajectory is occupied for ~8% of the timeline
    def density_fn(p, t):
        c = jnp.array([-0.8 + 1.6 * t, 0.0, 0.0])
        d2 = jnp.sum((p - c) ** 2, axis=-1)
        return jnp.where(d2 < 0.12 ** 2, 200.0, 0.0)

    key = jax.random.PRNGKey(0)
    S = 4
    for i in range(40):
        key, k_u, k_t = jax.random.split(key, 3)
        # trainer's stratified+jittered refresh times
        ts = (jnp.arange(S) + jax.random.uniform(k_t, (S,))) / S
        grid = spec.update(grid, k_u, density_fn, thresh=1.0, times=ts)

    g = np.asarray(grid)
    G = spec.grid_size
    centers = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    # trajectory cells: |y|,|z| small, x anywhere in the sweep
    yz = np.abs(centers) < 0.12
    x_on = (centers > -0.8) & (centers < 0.8)
    traj = g[np.ix_(x_on, yz, yz)]
    assert (traj > 1.0).mean() > 0.9, (
        f"moving-object cells decayed: {traj.min()=} "
        f"{(traj > 1.0).mean()=}")
    # far-away cells (never occupied at any time) must decay out
    far = g[:, 12:, 12:]
    assert (far < 1.0).mean() > 0.9


def test_occupancy_single_time_refresh_loses_moving_object():
    """Control for the retention test: the r2 behavior (every refresh at the
    same fixed time) demonstrably culls the moving object."""
    spec = OccupancyGridSpec(grid_size=16, bound=1.0, decay=0.8,
                             update_fraction=1)
    grid = spec.init()

    def density_fn(p, t):
        c = jnp.array([-0.8 + 1.6 * t, 0.0, 0.0])
        d2 = jnp.sum((p - c) ** 2, axis=-1)
        return jnp.where(d2 < 0.12 ** 2, 200.0, 0.0)

    key = jax.random.PRNGKey(0)
    t0 = jnp.zeros((1,))                       # times[0] only (old behavior)
    for i in range(40):
        key, k_u = jax.random.split(key)
        grid = spec.update(grid, k_u, density_fn, thresh=1.0, times=t0)
    g = np.asarray(grid)
    G = spec.grid_size
    centers = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    yz = np.abs(centers) < 0.12
    x_late = centers > 0.0                     # object is there only at t>0.5
    traj_late = g[np.ix_(x_late, yz, yz)]
    assert (traj_late < 1.0).mean() > 0.8     # the bug: culled


def test_occ_refresh_cadence_mid_epoch(tmp_path):
    """occ_update_interval must be honored DURING a scan epoch, not once per
    epoch: 16 steps/epoch at interval 4 -> 4 refreshes."""
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    tr = Trainer(tiny_config(render_mode="occupancy", num_steps=96,
                             num_steps_occ=32, occ_grid_size=32,
                             occ_update_interval=4,
                             change_patch_size_lidar=[1]),
                 scene, workspace=str(tmp_path))
    n = len(scene)
    order = np.resize(np.arange(n), 16)
    tr.epoch = 1
    tr.train_one_epoch(order=order)
    assert tr._occ_refresh_count == 16 // 4, tr._occ_refresh_count
    tr.train_one_epoch(order=order)
    assert tr._occ_refresh_count == 2 * (16 // 4), tr._occ_refresh_count


def test_occ_refresh_times_stratified(tmp_path):
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    tr = Trainer(tiny_config(render_mode="occupancy", num_steps=96,
                             num_steps_occ=32, occ_grid_size=32,
                             change_patch_size_lidar=[1]),
                 scene, workspace=str(tmp_path))
    ts = np.asarray(tr._occ_refresh_times(jax.random.PRNGKey(3)))
    S = tr.cfg.occ_time_samples
    assert len(ts) == S
    t = np.asarray(scene.times)
    lo, hi = t.min(), t.max()
    assert (ts >= lo - 1e-6).all() and (ts <= hi + 1e-6).all()
    # one sample per stratum
    strata = np.floor((ts - lo) / (hi - lo) * S - 1e-9)
    np.testing.assert_array_equal(np.sort(strata), np.arange(S))


def test_render_skip_warp_option(tmp_path):
    """skip_warp renders: staged-occ equals direct run_occupancy with
    skip_warp=True, the result differs from the full temporal blend (the
    option really changes the query), and the config knob reaches the
    trainer's render kwargs."""
    from nvsf_tpu.render.renderer import RendererSpec
    from test_renderer import TINY_FIELD
    rend = RendererSpec(field=TINY_FIELD, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=32, max_ray_batch=8)
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = spec.init()  # fully occupied
    params = TINY_FIELD.init(jax.random.PRNGKey(0))
    o = jnp.zeros((12, 3))
    d = jax.random.normal(jax.random.PRNGKey(1), (12, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(occ_spec=spec, occ_grid=grid, num_steps_occ=32,
              cal_lidar_color=True)
    direct = rend.render(params, o, d, 0.5, skip_warp=True, **kw)
    staged = rend.render(params, o, d, 0.5, skip_warp=True, staged=True,
                         **kw)
    np.testing.assert_allclose(np.asarray(staged["depth_lidar"]),
                               np.asarray(direct["depth_lidar"]),
                               rtol=1e-4, atol=1e-6)
    # the option really changes the query (at init the flow net is ~0 and
    # the time-bin tables nearly agree, so the difference is small but
    # must be nonzero — bitwise equality would mean the flag didn't route)
    full = rend.render(params, o, d, 0.5, **kw)
    diff = np.abs(np.asarray(full["depth_lidar"])
                  - np.asarray(direct["depth_lidar"]))
    assert diff.max() > 0.0

    from test_trainer import SCENE_SPEC, tiny_config
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    cfg = tiny_config(render_mode="occupancy", num_steps_occ=16,
                      occ_grid_size=8, render_skip_warp=True)
    tr = Trainer(cfg, scene, workspace=str(tmp_path), seed=0)
    g = tr.state["occ_grid_lidar"]
    assert tr._occ_kwargs(g, lidar=True)["skip_warp"] is True
    cfg0 = tiny_config(render_mode="occupancy", num_steps_occ=16,
                       occ_grid_size=8)
    tr0 = Trainer(cfg0, scene, workspace=str(tmp_path), seed=0)
    assert tr0._occ_kwargs(tr0.state["occ_grid_lidar"])["skip_warp"] is False


def test_render_skip_warp_reaches_sweep():
    """The batched sweep path (what evaluate()/refine() actually render
    through) must honor occ_kwargs['skip_warp'] — a regression test for the
    sweep factories dropping the flag (the quality ablation silently
    measured identical arms)."""
    from nvsf_tpu.render.renderer import RendererSpec
    from nvsf_tpu.render.sweep import render_lidar_sweep
    from nvsf_tpu.lib import rays as raylib
    from test_renderer import TINY_FIELD
    rend = RendererSpec(field=TINY_FIELD, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=32, max_ray_batch=32)
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = spec.init()
    params = TINY_FIELD.init(jax.random.PRNGKey(0))
    H, W = 4, 8
    K_l, K_hoz = (2.0, 26.9), (180.0, 360.0)
    poses = np.eye(4, dtype=np.float32)[None]
    times = np.array([0.5], np.float32)
    base = dict(occ_spec=spec, occ_grid=grid, num_steps_occ=32,
                occ_thresh=0.01)
    sw_on = render_lidar_sweep(rend, params, poses, times, H, W, K_l, K_hoz,
                               occ_kwargs=dict(base, skip_warp=True))
    sw_off = render_lidar_sweep(rend, params, poses, times, H, W, K_l, K_hoz,
                                occ_kwargs=dict(base, skip_warp=False))
    assert np.abs(sw_on["depth"] - sw_off["depth"]).max() > 0.0
    # and the sweep's skip_warp render equals the direct staged render on
    # the same rays
    inds = jnp.arange(H * W, dtype=jnp.int32)
    ro, rd = raylib.get_lidar_rays(jnp.asarray(poses[0]), inds, H, W,
                                   K_l, K_hoz)
    direct = rend.render(params, ro, rd, 0.5, cal_lidar_color=True,
                         staged=True, skip_warp=True, **base)
    np.testing.assert_allclose(sw_on["depth"][0].reshape(-1),
                               np.asarray(direct["depth_lidar"]),
                               rtol=1e-4, atol=1e-6)


def test_delta_clamp_invariant_when_gapless_and_caps_gaps():
    """occ_delta_clamp (r5, reference local-dt quadrature option):
    with a fully-occupied grid and K == T there are no skipped gaps —
    clamp=1.0 must match the legacy quadrature up to the linspace
    endpoint effect (candidate spacing is (far-near)/(T-1), a factor
    T/(T-1) above sample_dist=(far-near)/T, so the clamp trims interior
    deltas ~3% at T=32); with K < T (strided gaps) the clamped path
    must composite LESS opacity per sample (weights_sum <=), never
    more."""
    from nvsf_tpu.render.renderer import RendererSpec
    from test_renderer import TINY_FIELD
    import dataclasses
    base = RendererSpec(field=TINY_FIELD, bound=1.0, min_near_lidar=0.02,
                        lidar_max_depth=0.9, num_steps=32)
    clamped = dataclasses.replace(base, occ_delta_clamp=1.0)
    spec = OccupancyGridSpec(grid_size=8, bound=1.0)
    grid = spec.init()
    params = TINY_FIELD.init(jax.random.PRNGKey(0))
    o = jnp.zeros((8, 3))
    d = jax.random.normal(jax.random.PRNGKey(1), (8, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    a = base.run_occupancy(params, o, d, 0.5, spec, grid,
                           num_steps_occ=32, cal_lidar_color=True)
    b = clamped.run_occupancy(params, o, d, 0.5, spec, grid,
                              num_steps_occ=32, cal_lidar_color=True)
    np.testing.assert_allclose(np.asarray(b["depth_lidar"]),
                               np.asarray(a["depth_lidar"]),
                               rtol=2e-2)
    a8 = base.run_occupancy(params, o, d, 0.5, spec, grid,
                            num_steps_occ=8, cal_lidar_color=True)
    b8 = clamped.run_occupancy(params, o, d, 0.5, spec, grid,
                               num_steps_occ=8, cal_lidar_color=True)
    ws_a = np.asarray(a8["weights_sum_lidar"])
    ws_b = np.asarray(b8["weights_sum_lidar"])
    assert (ws_b <= ws_a + 1e-6).all()
    assert (ws_b < ws_a - 1e-4).any(), \
        "clamp should reduce per-sample opacity across strided gaps"
