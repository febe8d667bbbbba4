"""Decompose the production loop's time by component.

bench.py's joint-tuned cell times the plain random-pixel step on 16
frames; tools/production_run.py runs the REAL schedule (63 frames,
patch/error-map alternation, occupancy refreshes). This script times each
component of the real schedule separately at the production shape:

  - random-epoch scan dispatch (the bench-like regime, 63 frames)
  - patch-epoch scan dispatch (patch sampling + structural regularizers +
    error-map sampling)
  - one occupancy refresh pair
  - checkpoint save

and prints a JSON decomposition. Every timing ends with a device->host
scalar fetch.

Usage: python tools/prod_decompose.py [--frames 64] [--reps 2]
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np

from production_run import build_flagship_trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--shape", choices=["tuned", "reference"],
                    default="tuned")
    ap.add_argument("--skip-patch", action="store_true",
                    help="time only the random-epoch scan (quick A/Bs)")
    ap.add_argument("--dispatch-steps", type=int, default=0)
    ap.add_argument("--encoder-remat", type=int, default=None,
                    help="override encoder_remat (0/1); bench runs 0 "
                         "(faster, more HBM), the shipped config default "
                         "was 1 — another bench-vs-production divergence")
    ap.add_argument("--remat-chunks", type=int, default=None,
                    help="override the shipped config's remat_chunks — "
                         "the occupancy-mode step evaluates only K<=128 "
                         "samples/ray, where the dense-768 remat is "
                         "suspected pure overhead (bench already runs "
                         "remat_chunks=1)")
    args = ap.parse_args()

    import jax

    over = {}
    if args.remat_chunks is not None:
        over["remat_chunks"] = args.remat_chunks
    if args.encoder_remat is not None:
        over["encoder_remat"] = bool(args.encoder_remat)
    if args.dispatch_steps:
        over["max_dispatch_steps"] = args.dispatch_steps
    cfg, tr, scene, _ = build_flagship_trainer(args.frames, 10,
                                               os.path.join(
                                                   tempfile.gettempdir(),
                                                   "nvsf_decomp"),
                                               shape=args.shape,
                                               extra_overrides=over or None)
    n = len(scene)
    rays = cfg.num_rays_lidar + cfg.num_rays
    interval = cfg.max_dispatch_steps or cfg.occ_update_interval
    order = np.arange(interval, dtype=np.int32)
    print(json.dumps({"shape": args.shape,
                      "remat_chunks": cfg.remat_chunks,
                      "encoder_remat": cfg.encoder_remat,
                      "dispatch_steps": interval}), flush=True)

    def fetch(state):
        jax.device_get(state["step"])

    def time_scan(scan, label):
        # warm (compile)
        t0 = time.time()
        tr.state, m = scan(tr.state, np.asarray(order))
        fetch(tr.state)
        compile_s = time.time() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.time()
            tr.state, m = scan(tr.state, np.asarray(order))
            fetch(tr.state)
            ts.append(time.time() - t0)
        per_step = min(ts) / len(order)
        print(json.dumps({
            "component": label, "steps_per_dispatch": len(order),
            "compile_s": round(compile_s, 1),
            "warm_s_per_step": round(per_step, 4),
            "rays_per_sec": round(rays / per_step, 1)}), flush=True)
        return per_step

    t_rand = time_scan(tr._scan_random, "random_epoch_scan")
    if args.skip_patch:
        return
    t_patch = time_scan(tr._scan_patch, "patch_epoch_scan") \
        if tr._scan_patch is not None else t_rand

    # occupancy refresh pair (one host-triggered dispatch per grid)
    tr._last_occ_update = -999
    t0 = time.time()
    tr._maybe_update_occ()
    jax.device_get(tr.state["occ_grid_lidar"][0, 0, 0])
    refresh_cold = time.time() - t0
    tr._last_occ_update = -999
    t0 = time.time()
    tr._maybe_update_occ()
    jax.device_get(tr.state["occ_grid_lidar"][0, 0, 0])
    refresh_s = time.time() - t0
    print(json.dumps({"component": "occ_refresh_pair",
                      "compile_s": round(refresh_cold, 1),
                      "warm_s": round(refresh_s, 3)}), flush=True)

    t0 = time.time()
    tr.save_checkpoint(full=True)
    ckpt_s = time.time() - t0
    print(json.dumps({"component": "checkpoint_save",
                      "s": round(ckpt_s, 2)}), flush=True)

    # epoch model: alternating schedule -> half the epochs are patch.
    # Refreshes are tick-keyed to global_step at occ_update_interval —
    # NOT to dispatch-chunk boundaries (max_dispatch_steps adds chunks
    # below the interval without extra refreshes)
    refr_per_epoch = n / cfg.occ_update_interval
    t_epoch_mixed = n * (t_rand + t_patch) / 2 \
        + refr_per_epoch * refresh_s
    print(json.dumps({
        "model": {
            "epoch_s_random_only": round(n * t_rand + refr_per_epoch
                                         * refresh_s, 1),
            "epoch_s_patch_only": round(n * t_patch + refr_per_epoch
                                        * refresh_s, 1),
            "epoch_s_alternating": round(t_epoch_mixed, 1),
            "sustained_rays_per_sec_alternating":
                round(rays * n / t_epoch_mixed, 1),
            "patch_over_random": round(t_patch / t_rand, 3),
        }}), flush=True)


if __name__ == "__main__":
    main()
