"""Flagship-config quality trajectory at FULL KITTI-360 scale.

Extends tools/production_run.py (throughput/HBM proof) with the quality
axis: trains the SHIPPED flagship configuration (built by
production_run.build_flagship_trainer — 4x8 hash, 4x32 flow, LiDAR K=96 /
camera K=128, flow + URF + error-map + patch schedule, occupancy mode) on
the synthetic stand-in scene at full KITTI-360 geometry — 64 frames,
66x1030 panos, 2048+2048 joint rays — and evaluates the held-out val
frames periodically with the production streaming renderer.  The
reference's quality loop is ``nerf/trainer.py:1019-1099``
(train) + ``:1458-1846`` (eval every ``eval_interval``); this is that loop
at that scale, one dataset mount away from the real thing.

Two-arm mode: ``--shape reference`` trains the SAME
full-scale run with the reference encoder shape (8x4 hash, 16x8 flow);
``--seed`` varies init/sampling. Comparing matched-epoch evals between
arms, against the seed spread, grounds the tuned-shape quality-equivalence
claim at production scale (2^19 tables, 66x1030 panos, 63 train frames).

Each epoch is ONE train_one_epoch call, so EMA decays once per epoch
exactly like the CLI loop and the reported loss is the true epoch mean.

The run checkpoints (full state incl. occupancy grids + error maps) at
every eval and supports ``--resume``: a crashed/killed run relaunched with
the same args continues from the last checkpointed epoch.

Usage: python tools/quality_run_full.py [--epochs 120] [--eval-every 15]
           [--shape tuned|reference] [--seed 0] [--resume]
Writes one JSON line per epoch and per eval to stdout.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np

from production_run import build_flagship_trainer, hbm_stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=15)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--shape", choices=["tuned", "reference"],
                    default="tuned")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workspace", default=None)
    ap.add_argument("--dispatch-steps", type=int, default=0,
                    help="cap steps per scan dispatch (max_dispatch_steps; "
                         "0 = one dispatch per occupancy-refresh interval)")
    ap.add_argument("--remat-chunks", type=int, default=None,
                    help="override remat_chunks (quality-neutral: remat "
                         "only recomputes; occupancy-mode steps fit HBM "
                         "without it and run faster)")
    args = ap.parse_args()

    t0 = time.time()
    ws = args.workspace or os.path.join(
        tempfile.gettempdir(), f"nvsf_quality_{args.shape}_s{args.seed}")
    over = {}
    if args.dispatch_steps:
        over["max_dispatch_steps"] = args.dispatch_steps
    if args.remat_chunks is not None:
        over["remat_chunks"] = args.remat_chunks
    cfg, tr, train_scene, val_scene = build_flagship_trainer(
        args.frames, args.epochs, ws, shape=args.shape, seed=args.seed,
        extra_overrides=over or None)
    from nvsf_tpu.train.evaluate import evaluate
    start_ep = 1
    if args.resume and tr.load_checkpoint("latest"):
        start_ep = tr.epoch + 1
        print(json.dumps({"resumed_from_epoch": tr.epoch}), flush=True)
    print(json.dumps({"config": {
        "shape": args.shape, "seed": args.seed,
        "rays": [cfg.num_rays_lidar, cfg.num_rays],
        "K": [cfg.num_steps_occ, cfg.num_steps_occ_rgb],
        "hash": [cfg.n_levels_hash, cfg.n_features_per_level_hash],
        "flow": [cfg.flow_n_levels, cfg.flow_n_features_per_level],
        "log2_hashmap": cfg.log2_hashmap_size,
        "frames": [len(train_scene), len(val_scene)],
        "pano": [train_scene.H_lidar, train_scene.W_lidar]}}), flush=True)

    for ep in range(start_ep, args.epochs + 1):
        tr.epoch = ep
        te0 = time.time()
        # epoch order keyed to (seed, epoch) — resume-INVARIANT: a run
        # restarted at any epoch draws the same orders the uninterrupted
        # run would have (no hidden resume-point variable in the two-arm
        # comparison)
        order = np.random.default_rng(
            args.seed * 100003 + ep).permutation(len(train_scene))
        stats = tr.train_one_epoch(order=order)
        row = {"epoch": ep, "loss": round(stats.loss, 3),
               "loss_d": round(stats.parts.get("loss_d", float("nan")), 2),
               "epoch_s": round(time.time() - te0, 1),
               "t": round(time.time() - t0, 1), **hbm_stats()}
        print(json.dumps(row), flush=True)
        if ep % args.eval_every == 0 or ep == args.epochs:
            tr.save_checkpoint(full=True)
            tv0 = time.time()
            res = evaluate(tr, val_scene, use_ema=True,
                           log_fn=lambda *a: None)
            c = res["combined"]
            print(json.dumps({
                "eval_epoch": ep, "shape": args.shape, "seed": args.seed,
                "CD": round(c["point"][0], 4),
                "F": round(c["point"][1], 4),
                "depth_RMSE": round(c["depth"][0], 4),
                "intensity_RMSE": round(c["intensity"][0], 4),
                "raydrop_acc": round(c["raydrop"][1], 4),
                "PSNR": round(c["rgb_psnr"], 2),
                "SSIM": round(c["rgb_ssim"], 4),
                "eval_s": round(time.time() - tv0, 1),
                "t": round(time.time() - t0, 1)}), flush=True)
    tr.save_checkpoint(full=True)
    print(json.dumps({"done": True, "total_s": round(time.time() - t0, 1),
                      **hbm_stats()}), flush=True)


if __name__ == "__main__":
    main()
