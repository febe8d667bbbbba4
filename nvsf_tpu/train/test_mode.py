"""Test mode: render every frame (GT optional — supports novel-sensor
synthesis), save pano/image PNGs, world- and lidar-frame point clouds, and
optional videos (rebuilds ``nvsf/nerf/trainer.py:1109-1283``)."""

from __future__ import annotations

import os

import numpy as np

from nvsf_tpu.lib import convert
from nvsf_tpu.lib.tools import write_png, write_pcd


def _to_u8(a, vmax=None):
    a = np.asarray(a, np.float32)
    vmax = vmax or max(float(a.max()), 1e-8)
    return (np.clip(a / vmax, 0, 1) * 255).astype(np.uint8)


def _write_videos(save_dir, name, depth_frames, rgb_frames, log_fn):
    """mp4 when an ffmpeg backend exists (``nvsf/nerf/trainer.py:1264-1281``
    writes mp4); otherwise fall back to GIF, which imageio writes natively
    with no external codec — the eval videos are short (tens of frames).
    Without the optional ``imageio`` package, logs and writes no video."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        if log_fn:
            log_fn("[test] imageio is not installed; skipping videos")
        return

    def write(frames, stem):
        if not frames:
            return
        path = os.path.join(save_dir, f"{stem}.mp4")
        try:
            imageio.mimwrite(path, frames, fps=10)
        except Exception:
            path = os.path.join(save_dir, f"{stem}.gif")
            # imageio GIF wants HxWx3; broadcast grayscale panos
            frames = [f if f.ndim == 3 else np.repeat(f[..., None], 3, -1)
                      for f in frames]
            imageio.mimwrite(path, frames, duration=100, loop=0)
        if log_fn:
            log_fn(f"[test] wrote {path}")

    try:
        write(depth_frames, f"{name}_depth")
        write(rgb_frames, f"{name}_rgb")
    except Exception as e:  # even the GIF fallback failed
        if log_fn:
            log_fn(f"[test] video writing unavailable: {e}")


def run_test(trainer, scene, *, save_dir, name="test", use_refine=False,
             write_video=False, log_fn=print):
    cfg = trainer.cfg
    os.makedirs(save_dir, exist_ok=True)
    depth_frames, rgb_frames = [], []
    for fi in range(len(scene)):
        t = float(scene.times[fi])
        if cfg.enable_lidar:
            pred = trainer.render_pano(
                scene.poses_lidar[fi], t, scene.H_lidar, scene.W_lidar,
                scene.intrinsics_lidar, scene.intrinsics_hoz_lidar,
                use_ema=True)
            raydrop = pred["raydrop"]
            if cfg.raydrop_loss == "bce":
                raydrop = 1.0 / (1.0 + np.exp(-raydrop))
            if use_refine and trainer.has_unet:
                raydrop = trainer.refine_raydrop_pano(
                    raydrop, pred["intensity"], pred["depth"])
            mask = (raydrop > cfg.raydrop_thres).astype(np.float32)
            depth = pred["depth"] * mask
            inten = pred["intensity"] * mask
            write_png(os.path.join(save_dir, f"{name}_{fi:04d}_depth.png"),
                      _to_u8(depth))
            write_png(os.path.join(save_dir,
                                   f"{name}_{fi:04d}_intensity.png"),
                      _to_u8(inten, vmax=1.0))
            # point clouds in lidar + world frames (``trainer.py:1147-1281``)
            pts = convert.pano_to_lidar_with_intensities(
                depth / cfg.scale, inten, scene.intrinsics_lidar,
                scene.intrinsics_hoz_lidar)
            np.savetxt(os.path.join(save_dir,
                                    f"{name}_{fi:04d}_pcd_lidar.txt"),
                       pts, fmt="%.6f")
            # .pcd alongside txt, like the reference's open3d writes
            # (``trainer.py:1147-1281``, ``tools.py:230-249``)
            write_pcd(os.path.join(save_dir, f"{name}_{fi:04d}_lidar.pcd"),
                      pts[:, :3], pts[:, 3])
            pose = np.array(scene.poses_lidar[fi], np.float64)
            pose[:3, 3] = pose[:3, 3] / cfg.scale + np.asarray(cfg.offset)
            pw = (pose @ np.column_stack(
                [pts[:, :3], np.ones(len(pts))]).T).T[:, :3]
            np.savetxt(os.path.join(save_dir,
                                    f"{name}_{fi:04d}_pcd_world.txt"),
                       np.column_stack([pw, pts[:, 3]]), fmt="%.6f")
            depth_frames.append(_to_u8(depth))
        if cfg.enable_rgb and scene.poses is not None:
            out = trainer.render_view(scene.poses[fi], t, scene.H, scene.W,
                                      scene.intrinsics, use_ema=True)
            write_png(os.path.join(save_dir, f"{name}_{fi:04d}_rgb.png"),
                      _to_u8(out["rgb"], vmax=1.0))
            rgb_frames.append(_to_u8(out["rgb"], vmax=1.0))
    if write_video:
        _write_videos(save_dir, name, depth_frames, rgb_frames, log_fn)
    if log_fn:
        log_fn(f"[test] wrote {len(scene)} frames to {save_dir}")
