"""Render-time K quality ablation.

The K x slab render sweep (tools/render_sweep.py) showed big speedups
from lowering the streaming marcher's kept-sample budget K at EVAL time
(flagship: K=96 is +20%, K=64 is +50% over the K=128 default) — but a
ray whose occupied-cell count exceeds K gets its integral truncated, so
the speedup is only shippable if held-out quality holds. This trains ONE
model at the flagship compaction ratio (K=32 of 192 candidates == the
768->128 flagship ratio, tuned encoder shape, the 60-epoch synthetic
protocol of tools/ablate_encoders.py), then evaluates the SAME weights with render-time
K' in {32, 24, 16} (flagship-equivalent {128, 96, 64}).

Usage: python tools/ablate_render_k.py [--epochs 60] [--backend cpu]
One JSON line per (K', metrics). Runs on JAX's default device (the GPU);
``--backend cpu`` forces the CPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--backend", default=None, choices=["cpu"],
                    help="force the CPU instead of JAX's default device")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; load the workspace checkpoint")
    args = ap.parse_args()

    import jax
    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from nvsf_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    ws = os.path.join(tempfile.gettempdir(), "nvsf_ablate_renderk")

    from tools.ablate_encoders import SHAPES, quality_run  # noqa: F401
    from nvsf_tpu.config import NVSFConfig
    from nvsf_tpu.data.synthetic import (SyntheticSceneSpec,
                                         make_synthetic_scene)
    from nvsf_tpu.train.evaluate import evaluate
    from nvsf_tpu.train.trainer import Trainer

    shape = SHAPES["tuned-4x8"]
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
        num_steps_occ=32, render_mode="occupancy", occ_grid_size=64,
        log2_hashmap_size=14, n_levels_plane=4,
        use_error_map=True, grad_loss=True,
        change_patch_size_lidar=[4, 4], change_patch_size_epoch=2,
        intrinsics_lidar=list(spec.intrinsics_lidar),
        intrinsics_hoz_lidar=list(spec.intrinsics_hoz_lidar),
        iters=args.epochs * len(train_scene), epochs=args.epochs,
        workspace=ws, **shape))
    tr = Trainer(cfg, train_scene, workspace=ws,
                 seed=0)
    t0 = time.time()
    if args.eval_only:
        tr.load_checkpoint()
    else:
        for ep in range(1, args.epochs + 1):
            tr.epoch = ep
            stats = tr.train_one_epoch()
            if ep % 10 == 0 or ep == args.epochs:
                print(json.dumps({"epoch": ep, "loss": round(stats.loss, 3),
                                  "t": round(time.time() - t0, 1)}),
                      flush=True)
        tr.save_checkpoint()

    # arms: render-time K' ladder, plus skip_warp (render WITHOUT the flow
    # eval / ±1-frame temporal blend — ~2.6x fewer gather rows per sample)
    # at the trained K, quantifying the approximation cost of the fast
    # render option (config `render_skip_warp`)
    arms = [(32, False), (24, False), (16, False), (32, True), (24, True)]
    for k_eval, sw in arms:
        tr.cfg = dataclasses.replace(tr.cfg, num_steps_occ=k_eval,
                                     render_skip_warp=sw)
        tr._render_cache.clear()
        res = evaluate(tr, val_scene, use_ema=True, log_fn=lambda *a: None)
        c = res["combined"]
        print(json.dumps({
            "render_K": k_eval, "flagship_equiv": k_eval * 4,
            "skip_warp": sw,
            "CD": round(c["point"][0], 4), "F": round(c["point"][1], 4),
            "depth_RMSE": round(c["depth"][0], 4),
            "raydrop_acc": round(c["raydrop"][1], 4),
            "PSNR": round(c["rgb_psnr"], 2),
            "SSIM": round(c["rgb_ssim"], 4),
            "t": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
