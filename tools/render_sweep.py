"""Render-path parameter sweep: full-frame eval render
through the occupancy-sorted early-exit marcher across K (kept samples)
x slab (samples per early-exit slab), plus the chunk-size axis.

Usage: python tools/render_sweep.py
Prints one JSON line per point; run on the GPU.
"""

import dataclasses
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    import jax
    from nvsf_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    import bench

    tag, cfg, tr, scene = bench._make_trainer(bench.HEADLINE)
    tr.train_one_epoch(order=np.arange(2))   # grid fresh-ish
    n_rays = scene.H_lidar * scene.W_lidar
    base_rend = tr.rend

    def measure(K, slab, chunk):
        tr.rend = dataclasses.replace(base_rend, stream_slab=slab,
                                      max_ray_batch=chunk)
        tr.cfg = dataclasses.replace(tr.cfg, num_steps_occ=K)
        tr._render_cache.clear()
        tr._eval_lidar = jax.jit(tr._render_frame_lidar)
        tr.render_lidar_frame(0)        # compile
        t0 = time.perf_counter()
        reps = 4
        for _ in range(reps):
            tr.render_lidar_frame(0)
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({"K": K, "slab": slab, "chunk": chunk,
                          "rays_per_sec": round(n_rays / dt, 1),
                          "ms_per_pano": round(dt * 1e3, 1)}),
              flush=True)

    for K in (64, 96, 128):
        for slab in (16, 32):
            if K % slab:
                continue
            measure(K, slab, base_rend.max_ray_batch)
    # chunk-size axis: smaller sorted chunks give finer early-exit
    # granularity (each chunk exits at ITS slowest ray) vs more dispatch
    # overhead in the lax.map
    for chunk in (1024, 2048, 8192):
        measure(96, 16, chunk)


if __name__ == "__main__":
    main()
