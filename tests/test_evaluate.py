"""Evaluation pipeline tests: meters over rendered frames, fg/bg category
masks from annotations, refined eval, artifact/JSON outputs."""

import json
import os

import numpy as np
import pytest

from nvsf_tpu.data.synthetic import make_synthetic_scene
from nvsf_tpu.lib import masks as masklib
from nvsf_tpu.train.evaluate import evaluate
from nvsf_tpu.train.trainer import Trainer

from test_trainer import SCENE_SPEC, tiny_config


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    tr = Trainer(tiny_config(enable_rgb=True, change_patch_size_lidar=[1]),
                 scene, workspace=ws)
    # the meters only need a FUNCTIONING model, not a converged one — one
    # short epoch keeps the module fixture's cost at ~one step compile
    tr.epoch = 1
    tr.train_one_epoch(order=np.arange(2))
    return tr


def test_masks_from_annotations():
    scene = make_synthetic_scene(SCENE_SPEC, split="val")
    assert scene.annotations and scene.annotations[0]
    gt = scene.images_lidar[0]
    static_m, dyn_m = masklib.compute_object_masks_pano(
        gt[:, :, 2], scene.poses_lidar[0], scene.annotations[0],
        scale=SCENE_SPEC.scale, offset=(0, 0, 0),
        intrinsics_lidar=scene.intrinsics_lidar,
        intrinsics_hoz_lidar=scene.intrinsics_hoz_lidar,
        max_depth=SCENE_SPEC.max_depth)
    assert static_m.shape == gt.shape[:2]
    assert dyn_m.sum() > 0          # the moving sphere is visible
    assert static_m.sum() > dyn_m.sum()


def test_image_masks_from_annotations():
    scene = make_synthetic_scene(SCENE_SPEC, split="val")
    st, dy = masklib.compute_object_masks_image(
        scene.poses[0], scene.intrinsics, scene.annotations[0],
        scene.H, scene.W, scale=SCENE_SPEC.scale, offset=(0, 0, 0))
    assert st.shape == (scene.H, scene.W)
    assert dy.sum() > 0


def test_category_masks_follow_reference_protocol():
    """Pred-derived masks apply to pred operands, gt-derived masks to gt
    operands (``nvsf/nerf/trainer.py:1586-1626``) — on a constructed frame
    where the two mask sets DIFFER, each category metric must equal a numpy
    oracle of the reference formula."""
    from nvsf_tpu.train.evaluate import lidar_category_masks
    from nvsf_tpu.lib import metrics as M

    scene = make_synthetic_scene(SCENE_SPEC, split="val")
    ann = scene.annotations[0]
    gt_depth = scene.images_lidar[0][:, :, 2] * scene.images_lidar[0][:, :, 0]
    # shift predicted depth so its point cloud moves pixels across the
    # bbox boundary: pred-derived masks differ from gt-derived masks
    pred_depth = np.roll(gt_depth, 5, axis=1) * 0.9
    kw = dict(scale=SCENE_SPEC.scale, offset=(0, 0, 0),
              intrinsics_lidar=scene.intrinsics_lidar,
              intrinsics_hoz_lidar=scene.intrinsics_hoz_lidar,
              max_depth=SCENE_SPEC.max_depth)
    cats = lidar_category_masks(pred_depth, gt_depth, scene.poses_lidar[0],
                                ann, **kw)
    assert set(cats) == {"combined", "background", "foreground"}
    mp_bg, mg_bg = cats["background"]
    assert not np.allclose(mp_bg, mg_bg), \
        "constructed frame must make pred/gt masks differ"

    # oracle: reference formula with independently computed masks
    static_p, dyn_p = masklib.compute_object_masks_pano(
        pred_depth, scene.poses_lidar[0], ann, **kw)
    static_g, dyn_g = masklib.compute_object_masks_pano(
        gt_depth, scene.poses_lidar[0], ann, **kw)
    for (mp, mg), (op, og) in [(cats["background"], (static_p, static_g)),
                               (cats["foreground"], (dyn_p, dyn_g))]:
        m = M.DepthMeter_L4D(scale=SCENE_SPEC.scale)
        m.update((pred_depth * mp)[None], (gt_depth * mg)[None])
        oracle = M.DepthMeter_L4D(scale=SCENE_SPEC.scale)
        oracle.update((pred_depth * op)[None], (gt_depth * og)[None])
        np.testing.assert_allclose(m.measure(), oracle.measure())
        # and the old (single-mask) protocol is measurably different —
        # compare FINITE columns only (LPIPS is NaN without weights, and
        # allclose on NaN pairs is vacuously False)
        old = M.DepthMeter_L4D(scale=SCENE_SPEC.scale)
        old.update((pred_depth * op)[None], (gt_depth * op)[None])
        a = np.asarray(old.measure())
        b = np.asarray(oracle.measure())
        fin = np.isfinite(a) & np.isfinite(b)
        assert fin.sum() >= 4, (a, b)
        assert not np.allclose(a[fin], b[fin]), (a, b)


def test_evaluate_produces_all_categories(trained, tmp_path):
    val = make_synthetic_scene(SCENE_SPEC, split="val")
    res = evaluate(trained, val, save_dir=str(tmp_path), name="t",
                   write_outputs=True, log_fn=None)
    assert set(res) == {"combined", "background", "foreground"}
    comb = res["combined"]
    assert "point" in comb and "depth" in comb and "raydrop" in comb
    assert "rgb_psnr" in comb and comb["rgb_psnr"] > 5
    cd, f = comb["point"]
    assert np.isfinite(cd)
    # artifacts
    assert os.path.exists(tmp_path / "t_error_matrix_combined.json")
    assert os.path.exists(tmp_path / "t_0000_depth.png")
    assert os.path.exists(tmp_path / "t_0000_rgb.png")
    assert os.path.exists(tmp_path / "t_0000_pcd_lidar.txt")
    # world-frame cloud + depth-error cloud (reference
    # ``trainer.py:1675-1712`` output contract)
    pw = np.loadtxt(tmp_path / "t_0000_pcd_world.txt")
    pe = np.loadtxt(tmp_path / "t_0000_pcd_error_world.txt")
    assert pw.shape[1] == 4 and pe.shape[1] == 4
    assert pw.shape[0] == pe.shape[0] > 0
    assert np.isfinite(pw).all() and np.isfinite(pe).all()
    # error column is bounded by the lidar range in meters
    max_m = trained.cfg.lidar_max_depth / trained.cfg.scale
    assert np.abs(pe[:, 3]).max() <= max_m + 1e-6
    j = json.loads((tmp_path / "t_error_matrix_combined.json").read_text())
    assert j["category"] == "combined"


def _synthetic_lpips_npz(path):
    """Random weights in the exporter schema (tools/export_lpips_weights.py)
    with reduced channel counts — shape-compatible with lpips_jax's AlexNet
    trunk walk, cheap enough for CPU tests."""
    rng = np.random.default_rng(0)
    chans = [(3, 8, 11), (8, 12, 5), (12, 16, 3), (16, 16, 3), (16, 16, 3)]
    w = {}
    for i, (cin, cout, k) in enumerate(chans):
        w[f"conv{i}_w"] = rng.normal(0, 0.1, (cout, cin, k, k)) \
            .astype(np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.1, (cout,)).astype(np.float32)
        w[f"lin{i}_w"] = rng.uniform(0, 1, (1, cout, 1, 1)) \
            .astype(np.float32)
    np.savez(path, **w)
    return str(path)


@pytest.mark.slow
def test_lpips_end_to_end_finite_json(tmp_path):
    """With a weights npz wired through the config, the FULL meter suite
    produces finite LPIPS everywhere — no NaN columns in the JSON error
    matrices (the reference works out of the box via the
    lpips pip package, ``error_matrices.py:473-515``).

    Needs panos >= ~31 px tall: below that AlexNet's conv/pool pyramid
    collapses to zero spatial size (torch lpips hard-errors there too),
    so this test trains its own taller-pano scene."""
    from nvsf_tpu.data.synthetic import SyntheticSceneSpec
    spec = SyntheticSceneSpec(num_frames=4, H_lidar=36, W_lidar=64,
                              H=36, W=48)
    scene = make_synthetic_scene(spec, split="train")
    wpath = _synthetic_lpips_npz(tmp_path / "lpips_syn.npz")
    cfg = tiny_config(enable_rgb=True, change_patch_size_lidar=[1],
                      num_frames=spec.num_frames, lpips_weights=wpath,
                      workspace=str(tmp_path))
    tr = Trainer(cfg, scene, workspace=str(tmp_path))
    tr.epoch = 1
    tr.train_one_epoch(order=np.arange(2))

    val = make_synthetic_scene(spec, split="val")
    res = evaluate(tr, val, save_dir=str(tmp_path), name="lp", log_fn=None)
    for cat, r in res.items():
        # depth/intensity 5-tuples: [RMSE, MedAE, LPIPS, SSIM, PSNR]
        assert np.isfinite(r["depth"][2]), (cat, r["depth"])
        assert np.isfinite(r["intensity"][2]), (cat, r["intensity"])
        assert np.isfinite(r["rgb_lpips"]), (cat, r)
    j = json.loads(
        (tmp_path / "lp_error_matrix_combined.json").read_text())
    # no NaN in any LPIPS column of the JSON (the "point" CD may be NaN at
    # 1 epoch: the untrained raydrop mask can drop EVERY point, and the
    # reference's PointsMeter NaNs identically on an empty cloud)
    assert np.isfinite(j["depth"][2]) and np.isfinite(j["intensity"][2])
    assert np.isfinite(j["rgb_lpips"])
    # distinct inputs score nonzero distance
    assert res["combined"]["rgb_lpips"] > 0


def test_lpips_jax_identity_is_zero(tmp_path):
    from nvsf_tpu.lib.lpips_jax import lpips_from_file
    wpath = _synthetic_lpips_npz(tmp_path / "w.npz")
    img = np.random.default_rng(1).uniform(0, 1, (33, 47, 3))
    assert lpips_from_file(wpath, img, img) == pytest.approx(0.0, abs=1e-6)
    other = np.clip(img + 0.3, 0, 1)
    assert lpips_from_file(wpath, img, other) > 0


@pytest.mark.slow
def test_refine_then_refined_eval(trained, tmp_path):
    losses = trained.refine(steps=30, log_fn=None)
    assert trained.has_unet
    val = make_synthetic_scene(SCENE_SPEC, split="val")
    res = evaluate(trained, val, use_refine=True, log_fn=None)
    assert np.isfinite(res["combined"]["raydrop"][0])


def test_video_export_fallback(tmp_path):
    """Video export writes mp4 when an ffmpeg backend exists, else falls
    back to native GIF — either way a playable file must appear."""
    from nvsf_tpu.train.test_mode import _write_videos
    depth = [np.full((8, 16), i * 20, np.uint8) for i in range(5)]
    rgb = [np.full((8, 16, 3), i * 20, np.uint8) for i in range(5)]
    msgs = []
    _write_videos(str(tmp_path), "t", depth, rgb, msgs.append)
    for stem in ("t_depth", "t_rgb"):
        paths = [tmp_path / f"{stem}.mp4", tmp_path / f"{stem}.gif"]
        written = [p for p in paths if p.exists()]
        assert written, f"no video written for {stem}: {msgs}"
        assert written[0].stat().st_size > 0
        if written[0].suffix == ".gif":
            # pin the duration semantics: this imageio passes duration
            # through in MILLISECONDS (older versions used seconds —
            # a 100s/frame GIF would be a frozen animation)
            from PIL import Image
            im = Image.open(written[0])
            im.seek(1)
            assert 50 <= im.info.get("duration", 0) <= 200, im.info


def test_novel_sensor_render(trained):
    """Novel intrinsics/resolution render: double the vertical beams."""
    val = make_synthetic_scene(SCENE_SPEC, split="val")
    out = trained.render_pano(val.poses_lidar[0], float(val.times[0]),
                              SCENE_SPEC.H_lidar * 2, SCENE_SPEC.W_lidar,
                              (12.0, 44.0), val.intrinsics_hoz_lidar)
    assert out["depth"].shape == (SCENE_SPEC.H_lidar * 2, SCENE_SPEC.W_lidar)
    assert np.isfinite(out["depth"]).all()
