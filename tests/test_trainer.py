"""End-to-end trainer tests on the analytic synthetic scene: the minimum
viable slice from SURVEY.md section 7 step 4 — LiDAR(+camera) field trained to
decreasing loss and improving depth error, plus checkpoint round-trip."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nvsf_tpu.config import NVSFConfig
from nvsf_tpu.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_tpu.train.trainer import Trainer

SCENE_SPEC = SyntheticSceneSpec(num_frames=6, H_lidar=24, W_lidar=64,
                                H=32, W=40)


def tiny_config(**over):
    base = dict(
        enable_lidar=True, enable_rgb=False,
        num_frames=SCENE_SPEC.num_frames,
        scale=SCENE_SPEC.scale,
        bound=1.0,
        min_near_lidar=0.5 * SCENE_SPEC.scale,
        lidar_max_depth=SCENE_SPEC.max_depth * SCENE_SPEC.scale,
        min_near=0.5 * SCENE_SPEC.scale,
        num_rays_lidar=256, num_rays=256,
        num_steps=96, max_ray_batch=512,
        lr=1e-2, iters=200, epochs=4, eval_interval=100,
        # tiny encoders for CPU speed
        min_resolution=8, n_levels_plane=2,
        base_resolution=16, max_resolution=128,
        time_resolution=4, n_levels_hash=4, log2_hashmap_size=12,
        workspace="/tmp/nvsf_tpu_test_ws",
        use_error_map=True,
        flow_n_levels=4, flow_n_features_per_level=4,
        flow_base_resolution=8, flow_max_resolution=32,
        flow_log2_hashmap_size=8,
        change_patch_size_lidar=[2, 8], change_patch_size_epoch=2,
        raydrop_loss="mse",
    )
    base.update(over)
    cfg = NVSFConfig.from_dict(base)
    object.__setattr__ if False else None
    return cfg


def _shrink_flow(cfg_dict):
    return cfg_dict


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(SCENE_SPEC, split="train")


def _make_trainer(scene, **over):
    cfg = tiny_config(**over)
    tr = Trainer(cfg, scene, workspace="/tmp/nvsf_tpu_test_ws")
    # shrink the flow grid for CPU tests
    return tr


@pytest.mark.slow
def test_lidar_training_loss_decreases(scene):
    # disable patch alternation so every epoch is the same regime
    tr = _make_trainer(scene, change_patch_size_lidar=[1])
    np.random.seed(0)
    losses = []
    for ep in range(1, 11):
        tr.epoch = ep
        losses.append(tr.train_one_epoch(order=np.arange(len(scene))).loss)
    assert min(losses[-3:]) < 0.5 * losses[0], losses


@pytest.mark.slow
def test_lidar_depth_improves(scene):
    tr = _make_trainer(scene)
    gt = scene.images_lidar[0]
    before = tr.render_lidar_frame(0)
    err_before = np.abs((before["depth"] - gt[:, :, 2]) * (gt[:, :, 0] > 0)).mean()
    for ep in range(1, 9):
        tr.epoch = ep
        tr.train_one_epoch(order=np.arange(len(scene)))
    after = tr.render_lidar_frame(0)
    err_after = np.abs((after["depth"] - gt[:, :, 2]) * (gt[:, :, 0] > 0)).mean()
    assert err_after < 0.7 * err_before, (err_before, err_after)


def test_joint_rgb_lidar_step(scene):
    tr = _make_trainer(scene, enable_rgb=True, use_rgbd_loss=True)
    s1 = tr.train_one_epoch(order=np.arange(2))
    assert np.isfinite(s1.loss)
    assert "rgb" in s1.parts and "chamfer" in s1.parts
    out = tr.render_camera_frame(0)
    assert out["rgb"].shape == (SCENE_SPEC.H, SCENE_SPEC.W, 3)


def test_flow_and_urf_losses_run(scene):
    tr = _make_trainer(scene, flow_loss=True, use_urf_loss=True,
                       flow_log2_hashmap_size=8)
    s = tr.train_one_epoch(order=np.arange(2))
    assert "flow" in s.parts and "urf" in s.parts
    assert np.isfinite(s.loss)


def test_patch_epoch_with_structural_reg(scene):
    tr = _make_trainer(scene, grad_loss=True, tv_loss=True)
    tr.epoch = 2  # patch epoch (epoch % change_patch_size_epoch == 0)
    s = tr.train_one_epoch(order=np.arange(2))
    assert "loss_sr" in s.parts
    assert np.isfinite(s.loss)


def test_error_map_evolves(scene):
    tr = _make_trainer(scene)
    em0 = np.asarray(tr.state["error_map"]).copy()
    tr.epoch = 2  # error map is updated every step; sampled on patch epochs
    tr.train_one_epoch(order=np.arange(len(scene)))
    em1 = np.asarray(tr.state["error_map"])
    assert not np.allclose(em0, em1)
    assert (em1 > 0).all()


@pytest.mark.slow  # fast tier covers this via the recovery/CLI tests
def test_checkpoint_roundtrip(scene, tmp_path):
    tr = _make_trainer(scene, workspace=str(tmp_path))
    tr.workspace = str(tmp_path)
    tr.train_one_epoch(order=np.arange(2))
    tr.epoch = 1
    path = tr.save_checkpoint(full=True)
    ref = tr.render_lidar_frame(0)

    tr2 = _make_trainer(scene, workspace=str(tmp_path))
    tr2.workspace = str(tmp_path)
    assert tr2.load_checkpoint("latest")
    out = tr2.render_lidar_frame(0)
    np.testing.assert_allclose(out["depth"], ref["depth"], atol=1e-5)
    # resume training works
    tr2.train_one_epoch(order=np.arange(2))


@pytest.mark.slow  # fast tier covers this via the recovery/CLI tests
def test_checkpoint_carries_full_production_state(scene, tmp_path):
    """Cross-process restore of the WHOLE render path:
    occupancy grids and the U-Net trained flag ride in the checkpoint, so a
    fresh process renders what the training process rendered — the
    reference keeps density_grid in the model state_dict
    (``nvsf/nerf/utils.py:610-680``)."""
    tr = _make_trainer(scene, workspace=str(tmp_path),
                       render_mode="occupancy", num_steps_occ=16,
                       occ_grid_size=32, occ_update_interval=4)
    tr.workspace = str(tmp_path)
    tr.epoch = 1
    tr.train_one_epoch(order=np.arange(len(scene)))
    # the refresh carved the grid away from the fully-occupied init
    fresh = np.asarray(tr.occ_spec.init())
    trained_grid = np.asarray(tr.state["occ_grid_lidar"])
    assert not np.allclose(trained_grid, fresh)
    ref = tr.render_lidar_frame(0)
    tr.save_checkpoint(full=True)

    # fresh-process stand-in: a new Trainer instance with re-initialized
    # (fully-occupied) grids
    tr2 = _make_trainer(scene, workspace=str(tmp_path),
                        render_mode="occupancy", num_steps_occ=16,
                        occ_grid_size=32, occ_update_interval=4)
    tr2.workspace = str(tmp_path)
    assert tr2.load_checkpoint("latest")
    np.testing.assert_allclose(np.asarray(tr2.state["occ_grid_lidar"]),
                               trained_grid)
    out = tr2.render_lidar_frame(0)
    np.testing.assert_allclose(out["depth"], ref["depth"], atol=1e-5)


def test_recovery_restore_preserves_occ_grid(scene, tmp_path):
    """A resilience-loop checkpoint restore must NOT reset the occupancy
    grids mid-run."""
    tr = _make_trainer(scene, workspace=str(tmp_path),
                       render_mode="occupancy", num_steps_occ=16,
                       occ_grid_size=32, occ_update_interval=4)
    tr.workspace = str(tmp_path)
    tr.epoch = 1
    tr.train_one_epoch(order=np.arange(len(scene)))
    trained_grid = np.asarray(tr.state["occ_grid_lidar"]).copy()
    tr.save_checkpoint(full=True)
    # simulate the recovery path: device state lost -> grids re-init
    tr.state["occ_grid_lidar"] = tr.occ_spec.init()
    assert tr.load_checkpoint("latest")
    np.testing.assert_allclose(np.asarray(tr.state["occ_grid_lidar"]),
                               trained_grid)


@pytest.mark.slow  # fast tier covers this via the recovery/CLI tests
def test_refine_checkpoint_preferred_for_eval(scene, tmp_path):
    """--test_eval --use_refine across processes: the *_refine checkpoint
    carries the trained U-Net + flag and is selected via prefer_refine
   ; training resume ('latest', no prefer) still gets
    the plain epoch checkpoint."""
    tr = _make_trainer(scene, workspace=str(tmp_path),
                       render_mode="occupancy", num_steps_occ=16,
                       occ_grid_size=32)
    tr.workspace = str(tmp_path)
    tr.epoch = 1
    tr.train_one_epoch(order=np.arange(2))
    tr.save_checkpoint(full=True)
    tr.refine(steps=3, log_fn=None)           # saves {name}_refine.pkl

    tr2 = _make_trainer(scene, workspace=str(tmp_path),
                        render_mode="occupancy", num_steps_occ=16,
                        occ_grid_size=32)
    tr2.workspace = str(tmp_path)
    assert tr2.load_checkpoint("latest", prefer_refine=True)
    assert tr2.unet_trained and tr2.has_unet
    # refined raydrop differs from raw raydrop through the restored U-Net
    pred = tr2.render_lidar_frame(0)
    refined = tr2.refine_raydrop_pano(pred["raydrop"], pred["intensity"],
                                      pred["depth"])
    assert not np.allclose(refined, pred["raydrop"])

    tr3 = _make_trainer(scene, workspace=str(tmp_path),
                        render_mode="occupancy", num_steps_occ=16,
                        occ_grid_size=32)
    tr3.workspace = str(tmp_path)
    assert tr3.load_checkpoint("latest")
    assert not tr3.unet_trained  # plain epoch ckpt predates refine


@pytest.mark.slow  # fast tier covers this via the recovery/CLI tests
def test_stale_refine_checkpoint_not_preferred(scene, tmp_path):
    """Staleness guard: training resumed PAST the refine stage writes newer
    epoch checkpoints; a pre-resume {name}_refine.pkl must not shadow them
    (its U-Net refined an older field)."""
    import os

    from nvsf_tpu.train.checkpoint import resolve_checkpoint

    tr = _make_trainer(scene, workspace=str(tmp_path),
                       render_mode="occupancy", num_steps_occ=16,
                       occ_grid_size=32)
    tr.workspace = str(tmp_path)
    tr.epoch = 1
    tr.train_one_epoch(order=np.arange(2))
    tr.save_checkpoint(full=True)
    tr.refine(steps=3, log_fn=None)
    ck = os.path.join(str(tmp_path), "checkpoints")
    refine_p = os.path.join(ck, "nvsf_refine.pkl")
    # refine is newest -> preferred
    assert resolve_checkpoint(str(tmp_path), "nvsf", "latest",
                              prefer_refine=True) == refine_p
    # resume past refine: a NEWER epoch checkpoint appears
    tr.epoch = 2
    tr.train_one_epoch(order=np.arange(2))
    newer = tr.save_checkpoint(full=True)
    os.utime(refine_p, (os.path.getmtime(newer) - 10,) * 2)
    got = resolve_checkpoint(str(tmp_path), "nvsf", "latest",
                             prefer_refine=True)
    assert got != refine_p and got.endswith(".pkl")


@pytest.mark.slow  # fast tier covers this via the recovery/CLI tests
def test_dispatch_cap_preserves_refresh_cadence(scene, tmp_path):
    """max_dispatch_steps adds scan-dispatch boundaries (bounding one
    device program's length) WITHOUT changing when occupancy refreshes fire:
    the tick is keyed to global_step, and sub-interval chunk boundaries
    must not trigger early refreshes."""
    def run(cap, ws):
        tr = _make_trainer(scene, workspace=ws, render_mode="occupancy",
                           num_steps_occ=16, occ_grid_size=32,
                           occ_update_interval=4, max_dispatch_steps=cap,
                           change_patch_size_lidar=[1])
        tr.workspace = ws
        fired = []
        orig = tr._maybe_update_occ

        def spy():
            before = tr._occ_refresh_count
            orig()
            if tr._occ_refresh_count > before:
                fired.append(tr.global_step)
        tr._maybe_update_occ = spy
        for ep in (1, 2):
            tr.epoch = ep
            tr.train_one_epoch(order=np.arange(len(scene)))
        return fired

    capped = run(2, str(tmp_path / "a"))
    uncapped = run(0, str(tmp_path / "b"))
    assert capped == uncapped and len(capped) >= 2, (capped, uncapped)


def test_ema_tracks_params(scene):
    tr = _make_trainer(scene)
    tr.train_one_epoch(order=np.arange(2))
    # sigma_net trains in lidar-only mode (color_net would not)
    p = tr.state["params"]["sigma_net"][0]["w"]
    e = tr.state["ema_params"]["sigma_net"][0]["w"]
    assert not np.allclose(np.asarray(p), np.asarray(e))


def test_far_plane_truncation_guard(scene):
    """r5 regression guard: a LiDAR far plane below the GT depth
    distribution (the finalize() double-scaling bug class — far landed
    at max_depth*scale^2 ~ 1 world meter in the production harnesses)
    must be refused at Trainer construction, not silently collapse."""
    with pytest.raises(ValueError, match="truncates the GT depth"):
        _make_trainer(scene,
                      lidar_max_depth=SCENE_SPEC.max_depth
                      * SCENE_SPEC.scale ** 2)
