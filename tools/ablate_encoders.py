"""Encoder-shape quality ablation.

Runs the 60-epoch synthetic quality protocol (8 frames, 32x96 pano,
held-out frame) once per encoder shape — the reference shape
(8-level x 4-feature hash, 16x8 flow, reference
``nerf/models/hash_field.py:108-119`` / ``flow_field.py:68-84``) vs the
tuned shapes (4x8 hash with 8x16 or 4x32 flow; the shipped
``configs/kitti360_1908.txt`` uses 4x32) — and prints the held-out-frame
metric comparison. Both shapes produce the same 32-dim encoder outputs;
the question is whether halving the multiresolution ladder hurts quality.

Usage: python tools/ablate_encoders.py [--epochs 60] [--eval-every 20]
                                      [--backend cpu]
Writes one JSON line per (shape, epoch) to stdout. Runs on JAX's default
device (the GPU); ``--backend cpu`` forces the CPU.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np


SHAPES = {
    "ref-8x4": dict(n_levels_hash=8, n_features_per_level_hash=4,
                    flow_n_levels=16, flow_n_features_per_level=8),
    "tuned-4x8": dict(n_levels_hash=4, n_features_per_level_hash=8,
                      flow_n_levels=8, flow_n_features_per_level=16),
    # the shipped flow shape (half the flow gather rows of 8x16; same
    # 32-dim folded output)
    "flow-4x32": dict(n_levels_hash=4, n_features_per_level_hash=8,
                      flow_n_levels=4, flow_n_features_per_level=32),
}


def quality_run(shape_name, shape, epochs, eval_every, seed=0, occ_k=64,
                eval_k=None, rgb_k=0):
    """eval_k: render-time K used by evaluate(); defaults to the training
    occ_k. Pinning it (e.g. 32) isolates TRAINING-K quality from
    render-time truncation."""
    import dataclasses

    import jax
    from nvsf_tpu.config import NVSFConfig
    from nvsf_tpu.data.synthetic import (SyntheticSceneSpec,
                                         make_synthetic_scene)
    from nvsf_tpu.train.evaluate import evaluate
    from nvsf_tpu.train.trainer import Trainer

    ws = os.path.join(tempfile.gettempdir(), f"nvsf_ablate_{shape_name}")
    spec = SyntheticSceneSpec(num_frames=8, H_lidar=32, W_lidar=96, H=40,
                              W=56, max_depth=25.0, scale=1.0 / 26.0)
    train_scene = make_synthetic_scene(spec, split="train")
    val_scene = make_synthetic_scene(spec, split="val")
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True,
        num_frames=spec.num_frames, scale=spec.scale, bound=1.0,
        min_near_lidar=1.0 * spec.scale, lidar_max_depth=25.0 * spec.scale,
        min_near=1.0 * spec.scale, active_sensor=True,
        num_rays=1024, num_rays_lidar=1024, num_steps=192,
        num_steps_occ=occ_k, num_steps_occ_rgb=rgb_k,
        render_mode="occupancy", occ_grid_size=64,
        log2_hashmap_size=14, n_levels_plane=4,
        use_error_map=True, grad_loss=True,
        change_patch_size_lidar=[4, 4], change_patch_size_epoch=2,
        intrinsics_lidar=list(spec.intrinsics_lidar),
        intrinsics_hoz_lidar=list(spec.intrinsics_hoz_lidar),
        iters=epochs * len(train_scene) // 1, epochs=epochs,
        workspace=ws, **shape))
    tr = Trainer(cfg, train_scene,
                 workspace=ws, seed=seed)
    t0 = time.time()
    for ep in range(1, epochs + 1):
        tr.epoch = ep
        stats = tr.train_one_epoch()
        print(json.dumps({"shape": shape_name, "epoch": ep,
                          "loss": round(stats.loss, 3),
                          "t": round(time.time() - t0, 1)}), flush=True)
        if ep % eval_every == 0 or ep == epochs:
            if eval_k is not None and eval_k != occ_k:
                train_cfg = tr.cfg
                tr.cfg = dataclasses.replace(tr.cfg, num_steps_occ=eval_k)
                tr._render_cache.clear()
            res = evaluate(tr, val_scene, use_ema=True, log_fn=lambda *a: None)
            if eval_k is not None and eval_k != occ_k:
                tr.cfg = train_cfg
                tr._render_cache.clear()
            c = res["combined"]
            # meter outputs: point=[CD, F@0.05]; depth=[RMSE, MedAE, LPIPS,
            # SSIM, PSNR]; raydrop=[RMSE, Acc, F1]
            rec = {"shape": shape_name, "epoch": ep,
                   "train_loss": round(stats.loss, 2),
                   "CD": round(c["point"][0], 4),
                   "F": round(c["point"][1], 4),
                   "depth_RMSE": round(c["depth"][0], 4),
                   "raydrop_acc": round(c["raydrop"][1], 4),
                   "PSNR": round(c["rgb_psnr"], 2),
                   "SSIM": round(c["rgb_ssim"], 4),
                   "t": round(time.time() - t0, 1)}
            print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--shapes", default="ref-8x4,tuned-4x8")
    ap.add_argument("--occ-K", type=int, default=64,
                    help="kept samples per ray (192 candidates); 32 matches "
                         "the flagship 768->128 compaction ratio")
    ap.add_argument("--eval-K", type=int, default=None,
                    help="render-time K for the held-out eval (default: "
                         "same as --occ-K)")
    ap.add_argument("--rgb-K", type=int, default=0,
                    help="camera-branch training K (0 = same as --occ-K)")
    ap.add_argument("--backend", default=None, choices=["cpu"],
                    help="force the CPU instead of JAX's default device")
    ap.add_argument("--seed", type=int, default=0,
                    help="trainer seed; replicate an arm at another seed "
                         "to quantify the noise floor behind the "
                         "'within noise' calls")
    args = ap.parse_args()
    import jax

    from nvsf_tpu.compile_cache import enable_compile_cache
    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    for name in args.shapes.split(","):
        quality_run(name, SHAPES[name], args.epochs, args.eval_every,
                    seed=args.seed, occ_k=args.occ_K, eval_k=args.eval_K,
                    rgb_k=args.rgb_K)


if __name__ == "__main__":
    main()
