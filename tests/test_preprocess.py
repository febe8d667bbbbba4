"""Preprocessing pipeline test on a synthetic mini KITTI-360 tree:
calibration chain, range views, transforms jsons, scene bounds, config, and
round-trip into the training dataset loader."""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from nvsf_tpu.config import parse_config_file, NVSFConfig
from nvsf_tpu.data.dataset import load_scene
from nvsf_tpu.preprocess import kitti360 as K

REC = "2013_05_28_drive_0000"
SEQ = "1908"
S, E, VAL = K.SEQUENCE_SPLITS[SEQ]


def _write_calib(root: Path):
    calib = root / "calibration"
    calib.mkdir(parents=True)
    fx, fy, cx, cy = 552.0, 552.0, 16.0, 12.0
    P = f"{fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0"
    R = "1 0 0 0 1 0 0 0 1"
    (calib / "perspective.txt").write_text(
        f"P_rect_00: {P}\nR_rect_00: {R}\nP_rect_01: {P}\nR_rect_01: {R}\n")
    # cam sits 0.3 above imu, rotated cam->imu (cam z forward = imu x)
    R_ci = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]]).T
    m = np.column_stack([R_ci, [0.0, 0.0, 0.3]])
    row = " ".join(str(v) for v in m.reshape(-1))
    (calib / "calib_cam_to_pose.txt").write_text(
        f"image_00: {row}\nimage_01: {row}\nimage_02: {row}\n"
        f"image_03: {row}\n")
    # cam00 -> velo: pure translation
    cv = np.column_stack([np.eye(3), [0.1, -0.2, 0.05]])
    (calib / "calib_cam_to_velo.txt").write_text(
        " ".join(str(v) for v in cv.reshape(-1)) + "\n")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def _write_poses(root: Path, frame_ids, drop=()):
    d = root / "data_poses" / f"{REC}_sync"
    d.mkdir(parents=True)
    lines = []
    for fid in frame_ids:
        if fid in drop:
            continue
        T = np.eye(4)
        T[:3, 3] = [0.5 * (fid - frame_ids[0]), 1.0, 0.2]
        lines.append(" ".join([str(fid)]
                              + [f"{v}" for v in T[:3].reshape(-1)]))
    (d / "poses.txt").write_text("\n".join(lines) + "\n")


def _write_velodyne(root: Path, frame_ids, rng):
    d = root / "data_3d_raw" / f"{REC}_sync" / "velodyne_points" / "data"
    d.mkdir(parents=True)
    for fid in frame_ids:
        n = 400
        r = rng.uniform(2, 20, n)
        az = rng.uniform(-np.pi, np.pi, n)
        incl = rng.uniform(np.radians(-24.9), np.radians(2.0), n)
        pts = np.stack([r * np.cos(incl) * np.cos(az),
                        r * np.cos(incl) * np.sin(az),
                        r * np.sin(incl),
                        rng.uniform(0, 1, n)], 1).astype(np.float32)
        pts.tofile(d / f"{fid:010d}.bin")


def _write_images(root: Path, frame_ids):
    import cv2
    d = root / "data_2d_raw" / f"{REC}_sync" / "image_00" / "data_rect"
    d.mkdir(parents=True)
    img = (np.random.default_rng(0).uniform(
        0, 255, (24, 32, 3))).astype(np.uint8)
    for fid in frame_ids:
        cv2.imwrite(str(d / f"{fid:010d}.png"), img)


def _write_bboxes(root: Path):
    d = root / "data_3d_bboxes" / "train_full"
    d.mkdir(parents=True)
    verts = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], float)
    data = " ".join(str(v) for v in verts.reshape(-1))
    T = np.eye(4)
    T[:3, 3] = [5.0, 1.0, 0.5]
    tdata = " ".join(str(v) for v in T.reshape(-1))
    xml = f"""<?xml version="1.0"?>
<opencv_storage>
<object_1>
  <label>car</label>
  <timestamp>-1</timestamp>
  <start_frame>{S}</start_frame>
  <end_frame>{E}</end_frame>
  <transform><rows>4</rows><cols>4</cols><data>{tdata}</data></transform>
  <vertices><rows>8</rows><cols>3</cols><data>{data}</data></vertices>
</object_1>
</opencv_storage>"""
    (d / f"{REC}_sync.xml").write_text(xml)


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    src = base / "source_data"
    frame_ids = list(range(S, E + 1))
    K_mat = _write_calib(src)
    _write_poses(src, frame_ids, drop=(S + 5,))  # one missing pose
    _write_velodyne(src, frame_ids, np.random.default_rng(1))
    _write_images(src, frame_ids)
    _write_bboxes(src)
    return base, src, K_mat


def test_calibration_chain(mini_kitti):
    base, src, K_mat = mini_kitti
    calib = K.KITTI360Calibration(src)
    np.testing.assert_allclose(calib.intrinsics("00"), K_mat)
    fids = list(range(S, E + 1))
    c2w = calib.cam_to_world(REC, fids)
    v2w = calib.velo_to_world(REC, fids)
    assert c2w.shape == (len(fids), 4, 4)
    # missing pose forward-filled
    np.testing.assert_allclose(c2w[5], c2w[4])
    # velo origin = imu origin + cam offset - velo offset chain is invertible
    assert np.isfinite(v2w).all()
    assert calib.verify_against_gt(REC)  # no GT file -> vacuous True


def test_full_preprocess_and_load(mini_kitti, tmp_path_factory):
    base, src, _ = mini_kitti
    ws = tmp_path_factory.mktemp("pp")
    cfg_path = K.preprocess_kitti360(
        src, base, SEQ, recording=REC, config_dir=str(ws / "configs"),
        workspace=str(ws / "log"), log_fn=None if False else (lambda *a: None),
        H=16, W=64)
    # range views exist
    rv = base / "train" / SEQ / f"{S:010d}.npy"
    assert rv.exists()
    arr = np.load(rv)
    assert arr.shape == (16, 64, 3)
    assert (arr[:, :, 2] > 0).sum() > 50
    # transforms
    tj = json.loads((base / "train" / SEQ /
                     f"transforms_{SEQ}_train.json").read_text())
    assert tj["num_frames"] == E - S + 1
    assert tj["num_frames_split"] == E - S + 1 - 4
    assert len(tj["frames"]) == tj["num_frames_split"]
    # config parses and trains-compatible
    d = parse_config_file(cfg_path)
    assert d["dataloader"] == "kitti360"
    assert 0 < d["scale"] < 1
    # load through the dataset layer
    cfg = NVSFConfig.from_dict(d)
    scene = load_scene(str(base), SEQ, "val", scale=cfg.scale,
                       offset=cfg.offset, enable_lidar=True, enable_rgb=True,
                       intrinsics_lidar=cfg.intrinsics_lidar,
                       intrinsics_hoz_lidar=cfg.intrinsics_hoz_lidar)
    assert len(scene) == 4
    assert scene.images_lidar.shape == (4, 16, 64, 3)
    assert scene.images.shape[0] == 4
    # poses recentered: translations within ~the unit box
    assert np.abs(scene.poses_lidar[:, :3, 3]).max() < 1.5


def test_preprocess_cli(mini_kitti, tmp_path_factory, capsys):
    """The argparse CLI drives the same pipeline end-to-end
    (``nvsf/scripts/preprocess_data.py:19-51``)."""
    from nvsf_tpu.scripts.preprocess_data import main as pp_main
    base, src, _ = mini_kitti
    ws = tmp_path_factory.mktemp("ppcli")
    data_root = ws / "data"
    pp_main(["--dataset", "kitti360", "--sequence_name", SEQ,
             "--recording", REC, "--kitti_root", str(src),
             "--data_root", str(data_root),
             "--config_dir", str(ws / "configs"),
             "--workspace", str(ws / "log")])
    out = capsys.readouterr().out
    assert "--config" in out
    cfg_path = ws / "configs" / f"kitti360_{SEQ}.txt"
    assert cfg_path.exists()
    d = parse_config_file(str(cfg_path))
    assert d["dataloader"] == "kitti360"
    # full-size default panos (66x1030) were generated
    arr = np.load(data_root / "train" / SEQ / f"{S:010d}.npy")
    assert arr.shape == (66, 1030, 3)


def test_novel_sensor_overrides(mini_kitti):
    base, src, _ = mini_kitti
    scene = load_scene(str(base), SEQ, "test", scale=0.02, offset=[0, 0, 0],
                       enable_lidar=True, enable_rgb=False,
                       novel_sensor={"delta_position": [0, 0, 1.0],
                                     "H_lidar_new": 32, "W_lidar_new": 128})
    assert scene.H_lidar == 34 and scene.W_lidar == 128
    assert scene.images_lidar is None  # GT disabled after overrides


def test_novel_sensor_camera_overrides(mini_kitti):
    """Camera-side overrides (``base_dataset.py:198-221``): pose delta in
    camera axes, resized image with cx/cy scaled (focal UNscaled — the
    reference ships that scaling commented out), GT nulled."""
    base, src, _ = mini_kitti
    plain = load_scene(str(base), SEQ, "test", scale=0.02, offset=[0, 0, 0],
                       enable_lidar=True, enable_rgb=True)
    scene = load_scene(str(base), SEQ, "test", scale=0.02, offset=[0, 0, 0],
                       enable_lidar=True, enable_rgb=True,
                       novel_sensor={"delta_pos_camera": [0, 0, 0.5],
                                     "H_new": 48, "W_new": 64})
    assert scene.H == 48 and scene.W == 64
    assert scene.images is None and scene.image_depths is None
    # cx/cy scaled by W_new/W, H_new/H; focal untouched
    np.testing.assert_allclose(scene.intrinsics[0, 2],
                               plain.intrinsics[0, 2] * 64 / plain.W)
    np.testing.assert_allclose(scene.intrinsics[1, 2],
                               plain.intrinsics[1, 2] * 48 / plain.H)
    np.testing.assert_allclose(scene.intrinsics[0, 0],
                               plain.intrinsics[0, 0])
    # pose moved (camera-axis remap of the delta)
    assert not np.allclose(scene.poses[0], plain.poses[0])
    # lidar side untouched by camera-only overrides
    np.testing.assert_allclose(np.asarray(scene.intrinsics_lidar),
                               np.asarray(plain.intrinsics_lidar))


def test_annotations_parse(mini_kitti):
    base, src, _ = mini_kitti
    anns = K.load_3d_annotations(src, REC, [S, S + 1])
    assert len(anns) == 2
    assert len(anns[0]) == 1
    v = anns[0][0]["vertices"]
    assert v.shape == (8, 3)
    np.testing.assert_allclose(v.mean(0), [5.0, 1.0, 0.5], atol=1e-6)


@pytest.mark.slow
def test_parity_harness_end_to_end(mini_kitti, tmp_path_factory):
    """The KITTI-360 parity protocol as one command chain: preprocess ->
    CLI train -> eval -> JSON error matrices. On a
    real KITTI-360 mount the same two commands produce reference-comparable
    numbers; this runs them end to end on the 2-frame-class mini fixture.
    """
    from nvsf_tpu.scripts.main_nvsf import main as cli_main

    base, src, _ = mini_kitti
    ws = tmp_path_factory.mktemp("parity")
    cfg_path = K.preprocess_kitti360(
        src, base, SEQ, recording=REC, config_dir=str(ws / "configs"),
        workspace=str(ws / "run"), log_fn=lambda *a: None, H=16, W=64)

    argv = [
        "--config", str(cfg_path),
        "--workspace", str(ws / "run"),
        "--epochs", "2", "--eval_interval", "1",
        "--num_rays_lidar", "128", "--num_rays", "128",
        "--num_steps", "32", "--num_steps_occ", "16",
        "--refine_steps", "2",
        "--n_levels_hash", "2", "--log2_hashmap_size", "8",
        "--flow_n_levels", "2", "--flow_log2_hashmap_size", "6",
        "--min_resolution", "8", "--n_levels_plane", "2",
        "--base_resolution", "16", "--max_resolution", "64",
        "--ckpt", "scratch",
    ]
    cli_main(argv)

    val_dir = ws / "run" / "validation"
    mats = list(val_dir.glob("*_error_matrix_*.json"))
    assert mats, f"no error matrices written in {val_dir}"
    m = json.loads(mats[0].read_text())
    assert "metrics" in m or len(m) > 0
