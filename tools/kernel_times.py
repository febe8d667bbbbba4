#!/usr/bin/env python3
"""Device times of the kernels that replaced hand-written ones, at the
flagship shapes, on an NVIDIA GPU.

  scatter   ``segment_add_fm`` (the table-gradient scatter-add) at the 7
            shapes one joint-tuned step calls it with, each call's
            distance from the bytes roofline, and their sum
  chamfer   the eval chamfer on one 66x1030 pano (~68k x 68k points):
            the shipped direct form ``sum((a-b)^2)`` against the
            ``|a|^2+|b|^2-2a.b`` form at "highest" and at default (TF32)
            matmul precision, each with its error against float64
  planes    the multi-corner plane sampler (``multihot_sample``) against
            one gather per plane segment, forward + backward, at the
            flagship dynamic-plane shape

Times are the median of ``--reps`` calls, each ending in
``block_until_ready``. Byte counts are the least the operation must move;
the roofline share is those bytes over the time, over the card's peak
bandwidth. Needs a GPU; exits non-zero otherwise.

Usage: python tools/kernel_times.py [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# peak device-memory bandwidth, bytes/s (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# (M update rows, F features, T table slots, producer) of the 7
# segment_add_fm calls in one joint-tuned step (2048 LiDAR rays x K=96,
# 2048 camera rays x K=128; 4-level x 8-feature hash, 4x32 flow hash)
SCATTER_SHAPES = [
    (6_291_456, 8, 2 ** 21, "LiDAR static hash"),
    (6_291_456, 8, 2 ** 20, "LiDAR flow hash"),
    (8_388_608, 8, 2 ** 21, "camera static hash"),
    (8_388_608, 8, 2 ** 20, "camera flow hash"),
    (9_437_184, 2, 196_608, "LiDAR dynamic planes"),
    (12_582_912, 2, 196_608, "camera dynamic planes"),
    (278_528, 8, 2 ** 20, "flow-loss point cloud"),
]


def timeit(fn, *args, reps):
    import jax
    jax.block_until_ready(fn(*args))               # compile + warm up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def emit(rec):
    print(json.dumps(rec), flush=True)


def bench_copy(peak, reps):
    import jax
    import jax.numpy as jnp
    x = jnp.ones((2 ** 28,), jnp.float32)          # 1 GiB
    dt = timeit(jax.jit(lambda a: a + 1.0), x, reps=reps)
    emit({"kernel": "copy_1GiB", "ms": dt * 1e3,
          "GB_per_s": 2 * x.nbytes / dt / 1e9,
          "roofline_share": 2 * x.nbytes / dt / peak})


def bench_scatter(peak, reps):
    import jax
    import jax.numpy as jnp
    from nvsf_tpu.ops.segsum import segment_add_fm
    f = jax.jit(segment_add_fm, static_argnums=2)
    key = jax.random.PRNGKey(0)
    total = 0.0
    for M, F, T, what in SCATTER_SHAPES:
        k1, k2, key = jax.random.split(key, 3)
        cols = jax.random.randint(k1, (M,), 0, T, jnp.int32)
        vals = jax.random.normal(k2, (F, M), jnp.float32)
        dt = timeit(f, cols, vals, T, reps=reps)
        total += dt
        nbytes = 4 * M + 4 * F * M + 4 * F * T     # read cols, vals; write T
        emit({"kernel": "segment_add_fm", "producer": what, "M": M, "F": F,
              "T": T, "ms": dt * 1e3, "GB_per_s": nbytes / dt / 1e9,
              "roofline_share": nbytes / dt / peak})
    emit({"kernel": "segment_add_fm_total", "ms": total * 1e3})


def _min_dist2_matmul(a, b, precision, block_m=4096):
    """The |a|^2+|b|^2-2a.b form, blocked over b like ops/chamfer.py."""
    import jax
    import jax.numpy as jnp
    pad = (-b.shape[0]) % block_m
    bb = jnp.pad(b, ((0, pad), (0, 0)), constant_values=1e6)
    bb = bb.reshape(-1, block_m, 3)
    a2 = jnp.sum(a * a, -1, keepdims=True)

    def step(carry, blk):
        d2 = a2 + jnp.sum(blk * blk, -1)[None] - 2.0 * jnp.matmul(
            a, blk.T, precision=precision)
        return jnp.minimum(carry, d2.min(-1)), None

    out, _ = jax.lax.scan(step, jnp.full((a.shape[0],), 1e10), bb)
    return jnp.maximum(out, 0.0)


def bench_chamfer(reps):
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    import chip_smoke
    from nvsf_tpu.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
    from nvsf_tpu.lib.convert import pano_to_lidar
    from nvsf_tpu.ops.chamfer import chamfer_distance

    spec = SyntheticSceneSpec(**dict(chip_smoke.SCENE, num_frames=1),
                              scale=1.0)
    pano = make_synthetic_scene(spec, split="all").images_lidar[0]
    gt = pano_to_lidar(pano[..., 2], spec.intrinsics_lidar,
                       spec.intrinsics_hoz_lidar)
    rng = np.random.default_rng(0)
    a = (gt + rng.normal(0.0, 0.05, gt.shape)).astype(np.float32)
    b = gt.astype(np.float32)
    r1 = cKDTree(b.astype(np.float64)).query(a.astype(np.float64))[0] ** 2
    r2 = cKDTree(a.astype(np.float64)).query(b.astype(np.float64))[0] ** 2
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    forms = {
        "direct": jax.jit(chamfer_distance),
        "matmul_highest": jax.jit(lambda x, y: (
            _min_dist2_matmul(x, y, jax.lax.Precision.HIGHEST),
            _min_dist2_matmul(y, x, jax.lax.Precision.HIGHEST))),
        "matmul_default": jax.jit(lambda x, y: (
            _min_dist2_matmul(x, y, None), _min_dist2_matmul(y, x, None))),
    }
    for name, fn in forms.items():
        dt = timeit(fn, ja, jb, reps=reps)
        d1, d2 = (np.asarray(x, np.float64) for x in fn(ja, jb))
        err = max(np.abs(d1 - r1).max(), np.abs(d2 - r2).max())
        f_ok = chip_smoke._fscore(d1, d2) - chip_smoke._fscore(r1, r2)
        emit({"kernel": f"chamfer_{name}", "points": [len(a), len(b)],
              "ms": dt * 1e3, "max_abs_err_m2": float(err),
              "fscore_err": float(f_ok)})


def bench_planes(peak, reps, Q=3, S=12, C=2, Np=196_608, F=8, W=256):
    import jax
    import jax.numpy as jnp
    from nvsf_tpu.ops.multihot import multihot_sample
    key = jax.random.PRNGKey(1)
    k1, k2, k3 = jax.random.split(key, 3)
    tables = jax.random.normal(k1, (F, Q * S * W), jnp.float32)
    cols = jax.random.randint(k2, (Q, S, C, Np), 0, W, jnp.int32)
    ws = jax.random.uniform(k3, (Q, S, C, Np), jnp.float32)

    def per_segment(t, w):
        out = []
        for q in range(Q):
            for s in range(S):
                seg = jax.lax.dynamic_slice_in_dim(t, (q * S + s) * W, W, 1)
                out.append(sum(w[q, s, c] * seg.at[:, cols[q, s, c]].get(
                    mode="promise_in_bounds") for c in range(C)))
        return jnp.stack(out).reshape(Q, S, F, Np)

    forms = {"multihot": lambda t, w: multihot_sample(t, cols, w, W),
             "per_segment_gather": per_segment}
    nbytes = 2 * (4 * Q * S * C * Np * 2 + 4 * Q * S * F * Np)
    for name, fn in forms.items():
        g = jax.jit(jax.grad(lambda t, w: jnp.sum(jnp.sin(fn(t, w))),
                             argnums=(0, 1)))
        dt = timeit(g, tables, ws, reps=reps)
        emit({"kernel": f"planes_{name}_fwd_bwd", "ms": dt * 1e3,
              "roofline_share": nbytes / dt / peak})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import jax

    from nvsf_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_times.py needs a GPU; JAX's default device "
                         f"is {dev} (platform {dev.platform})")
    if dev.device_kind not in PEAK_BYTES_PER_S:
        raise SystemExit(f"no peak bandwidth for {dev.device_kind!r}")
    peak = PEAK_BYTES_PER_S[dev.device_kind]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    bench_copy(peak, args.reps)
    bench_scatter(peak, args.reps)
    bench_chamfer(args.reps)
    bench_planes(peak, args.reps)


if __name__ == "__main__":
    main()
