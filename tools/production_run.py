"""Flagship KITTI-scale production run.

Trains the SHIPPED flagship configuration (configs/kitti360_1908.txt
shapes: 4-level x 8-feature hash encoders, 4-scale K-planes, flow + URF +
error-map + patch schedule, occupancy render mode) on a synthetic
stand-in scene at FULL KITTI-360 scale — 64 frames, 66x1030 panos,
2048+2048 joint rays — through the real Trainer epoch path (one
train_one_epoch call per epoch: the trainer itself splits the epoch scan
into occ_update_interval-sized dispatches, which honors the instant-ngp
refresh cadence), and records step time, cold/warm compile time, and
device-memory high-water.

This is the "one dataset-mount away" evidence that the production path
sustains at scale, not just the bench harness.

Usage: python tools/production_run.py [--epochs 3] [--frames 64]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np


def hbm_stats():
    import jax
    try:
        s = jax.local_devices()[0].memory_stats()
        return {"bytes_in_use": s.get("bytes_in_use"),
                "peak_bytes_in_use": s.get("peak_bytes_in_use"),
                "bytes_limit": s.get("bytes_limit")}
    except Exception:
        return {}


def build_flagship_trainer(frames: int, epochs: int, workspace: str,
                           shape: str = "tuned", seed: int = 0,
                           extra_overrides: dict = None, pano=None):
    """The SHIPPED flagship config (configs/kitti360_1908.txt) bound to a
    synthetic stand-in scene at full KITTI-360 geometry. Shared by
    production_run (throughput/HBM proof) and quality_run_full (quality
    trajectory) so both measure the same setup.

    ``shape``: 'tuned' keeps the shipped encoder shape (4x8 hash, 4x32
    flow); 'reference' swaps in the reference's encoder shape (8 levels x
    4 features hash, 16x8 flow — reference
    ``nerf/models/hash_field.py:108-133``, ``flow_field.py:68-84``) with
    EVERYTHING else identical — the production-scale two-arm
    quality-equivalence comparison."""
    from nvsf_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    from nvsf_tpu.config import NVSFConfig, parse_config_file
    from nvsf_tpu.data.synthetic import (SyntheticSceneSpec,
                                         make_synthetic_scene)
    from nvsf_tpu.train.trainer import Trainer

    flag = parse_config_file("configs/kitti360_1908.txt")
    if shape == "reference":
        flag.update(n_levels_hash=8, n_features_per_level_hash=4,
                    flow_n_levels=16, flow_n_features_per_level=8)
    elif shape != "tuned":
        raise ValueError(f"unknown shape {shape!r}")
    Hl, Wl = pano or (66, 1030)
    spec = SyntheticSceneSpec(num_frames=frames, H_lidar=Hl, W_lidar=Wl,
                              H=94, W=352, max_depth=80.0, scale=1.0 / 81.0)
    train_scene = make_synthetic_scene(spec, split="train")
    val_scene = make_synthetic_scene(spec, split="val")
    # near/far in METERS: NVSFConfig.finalize() scales them into the box
    # exactly once (main_nvsf.py:167-169 semantics). Pre-scaled values
    # here would be scaled twice, putting the far plane ~1 world metre
    # out and every LiDAR return beyond it.
    overrides = dict(
        num_frames=spec.num_frames, scale=spec.scale, bound=1.0,
        min_near_lidar=1.0, lidar_max_depth=float(spec.max_depth),
        min_near=1.0,
        intrinsics_lidar=list(spec.intrinsics_lidar),
        intrinsics_hoz_lidar=list(spec.intrinsics_hoz_lidar),
        dataloader="synthetic", path="", workspace=workspace,
        epochs=epochs)
    cfg_d = dict(flag)
    cfg_d.update(overrides)
    cfg_d.update(extra_overrides or {})
    cfg = NVSFConfig.from_dict(cfg_d).finalize(
        steps_per_epoch=len(train_scene))
    tr = Trainer(cfg, train_scene, workspace=workspace, seed=seed)
    return cfg, tr, train_scene, val_scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()

    t0 = time.time()
    cfg, tr, scene, _ = build_flagship_trainer(
        args.frames, args.epochs,
        os.path.join(tempfile.gettempdir(), "nvsf_prod"))
    print(json.dumps({"config": {
        "num_rays_lidar": cfg.num_rays_lidar, "num_rays": cfg.num_rays,
        "num_steps": cfg.num_steps, "num_steps_occ": cfg.num_steps_occ,
        "render_mode": cfg.render_mode,
        "n_levels_hash": cfg.n_levels_hash,
        "n_features_per_level_hash": cfg.n_features_per_level_hash,
        "flow": [cfg.flow_n_levels, cfg.flow_n_features_per_level],
        "enable_rgb": cfg.enable_rgb, "flow_loss": cfg.flow_loss,
        "frames": len(scene), "pano": [scene.H_lidar, scene.W_lidar],
        "occ_update_interval": cfg.occ_update_interval},
        "init_s": round(time.time() - t0, 1),
        "hbm_after_init": hbm_stats()}), flush=True)

    rng = np.random.default_rng(0)
    for ep in range(1, args.epochs + 1):
        tr.epoch = ep
        te0 = time.time()
        # ONE call per epoch: EMA updates once (decay 0.95/epoch, as the
        # CLI loop does)
        stats = tr.train_one_epoch(order=rng.permutation(len(scene)))
        ep_s = time.time() - te0
        steps = len(scene)
        rays = cfg.num_rays_lidar + (cfg.num_rays if cfg.enable_rgb else 0)
        print(json.dumps({
            "epoch": ep, "loss": round(stats.loss, 3),
            "epoch_s": round(ep_s, 1),
            "rays_per_sec": round(rays * steps / ep_s, 1),
            "note": "epoch 1 includes compile" if ep == 1 else "warm",
            "occ_refreshes": tr._occ_refresh_count,
            "hbm": hbm_stats()}), flush=True)
    tr.save_checkpoint(full=True)
    print(json.dumps({"done": True, "total_s": round(time.time() - t0, 1),
                      "hbm_final": hbm_stats()}), flush=True)


if __name__ == "__main__":
    main()
