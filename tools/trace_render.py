"""Device-trace the streaming occupancy render path (the bench render rung).

Like tools/trace_step.py but for `Trainer.render_lidar_frame` — the
occupancy-compacted early-exit marcher behind eval/test renders
(`render/renderer.py::run_occupancy_stream`). Prints ms/frame and the
device-op time grouped by kind, joined with HLO source metadata where the
compiled text is dumped.

Usage: python tools/trace_render.py [--frames 4] [--dir DIR]
(default DIR: nvsf_trace_render under the temp directory)
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "nvsf_trace_render"))
    ap.add_argument("--parse-only", action="store_true")
    args = ap.parse_args()

    from trace_step import summarize

    if args.parse_only:
        summarize(args.dir)
        return

    import jax
    from nvsf_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    import bench

    # same trained-model render setup as bench._run_render_bench
    tag, cfg, tr, scene = bench._make_trainer(dict(
        bench.HEADLINE, num_steps_occ_render=96, max_ray_batch=2048,
        occ_update_fraction=1))
    for ep in range(1, 7):
        tr.epoch = ep
        tr.train_one_epoch(order=np.resize(np.arange(16), 8))
    ts = tr._occ_refresh_times(jax.random.PRNGKey(1))
    for i in range(18):
        tr.state["occ_grid_lidar"] = tr._occ_update(
            tr.state["params"], tr.state["occ_grid_lidar"],
            jax.random.PRNGKey(0xACC0 + i), ts, True)

    tr.render_lidar_frame(0)                    # compile + warm
    n_rays = scene.H_lidar * scene.W_lidar

    t0 = time.perf_counter()
    jax.profiler.start_trace(args.dir)
    for i in range(args.frames):
        tr.render_lidar_frame(i % len(scene))
    jax.profiler.stop_trace()
    dt = time.perf_counter() - t0
    print(json.dumps({"frames": args.frames,
                      "ms_per_frame": round(dt / args.frames * 1e3, 1),
                      "rays_per_sec": round(n_rays * args.frames / dt, 1)}))
    summarize(args.dir)


if __name__ == "__main__":
    main()
