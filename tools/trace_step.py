"""In-situ decomposition of the REAL train step from a device trace.

Programs timed in isolation lose the overlap/fusion structure of the full
compiled step (their numbers do not sum to the measured step time). This
tool instead traces
the actual bench.py headline (or joint) step with jax.profiler, parses the
xplane with jax.profiler.ProfileData, and prints device-op time grouped by
op kind — the ground truth for where the step spends its time.

Usage: python tools/trace_step.py [--rung headline|joint-tuned|joint-8x4]
                                  [--steps 16] [--dir DIR]
(default DIR: nvsf_trace under the temp directory)
"""

import argparse
import collections
import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, ".")

import numpy as np


def _group(name: str) -> str:
    """XLA op name -> kind bucket: 'fusion.123' -> fusion, 'sort.5' -> sort."""
    base = name.split(".")[0]
    # strip e.g. 'loop_add_fusion' -> fusion-ish tails dominate; keep the
    # trailing token when the name is a descriptive fusion label
    for kind in ("fusion", "sort", "gather", "scatter", "convolution",
                 "dot", "copy", "custom-call", "dynamic-slice",
                 "dynamic-update-slice", "reduce", "transpose", "while",
                 "all-reduce", "all-gather", "rng"):
        if kind in name.split(".")[0]:
            return kind
    return base


def summarize(trace_dir: str, top: int = 30):
    import jax
    files = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    assert files, f"no xplane.pb under {trace_dir}"
    pd = jax.profiler.ProfileData.from_serialized_xspace(
        open(files[-1], "rb").read())
    by_kind = collections.Counter()
    by_name = collections.Counter()
    total = 0.0

    SKIP = ("ThunkExecutor", "ThreadpoolListener", "end:", "TaskDispatcher")

    def eat(line):
        nonlocal total
        for ev in line.events:
            if any(s in ev.name for s in SKIP):
                continue
            dur = (ev.duration_ns or 0) / 1e6
            by_kind[_group(ev.name)] += dur
            by_name[ev.name.split("/")[-1][:80]] += dur
            total += dur

    planes = list(pd.planes)
    dev_planes = [p for p in planes if "device" in p.name.lower()]
    if dev_planes:
        for plane in dev_planes:
            for line in plane.lines:
                lname = line.name.lower()
                # XLA op activity lanes only (skip steps/annotations)
                if "xla op" in lname or lname == "ops" \
                        or lname.startswith("xla"):
                    eat(line)
    else:   # CPU fallback: the PjRt client lane carries the op events
        for plane in planes:
            for line in plane.lines:
                if "XLAPjRt" in line.name:
                    eat(line)
    print(f"\ndevice op time total: {total:.1f} ms (over the traced span)")
    print(f"{'kind':28s} {'ms':>10s} {'%':>6s}")
    for k, v in by_kind.most_common(top):
        print(f"{k:28s} {v:10.1f} {100 * v / max(total, 1e-9):6.1f}")
    print("\ntop individual ops:")
    for k, v in by_name.most_common(15):
        print(f"  {v:10.1f} ms  {k}")
    return by_kind, total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rung", default="headline",
                    choices=["headline", "joint-tuned", "joint-8x4"])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(),
                                                  "nvsf_trace"))
    ap.add_argument("--parse-only", action="store_true",
                    help="just summarize an existing trace dir")
    args = ap.parse_args()

    if args.parse_only:
        summarize(args.dir)
        return

    import jax
    from nvsf_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    import bench

    over = {"headline": bench.HEADLINE,
            "joint-tuned": bench.JOINT_TUNED,
            "joint-8x4": bench.JOINT}[args.rung]
    tag, cfg, tr, _ = bench._make_trainer(over)
    frames = np.resize(np.arange(16), 8)
    tr.train_one_epoch(order=frames)          # compile + warm
    float(np.asarray(tr.state["step"]))

    import time
    t0 = time.perf_counter()
    jax.profiler.start_trace(args.dir)
    for _ in range(max(args.steps // 8, 1)):
        tr.train_one_epoch(order=frames)
    float(np.asarray(tr.state["step"]))
    jax.profiler.stop_trace()
    dt = time.perf_counter() - t0
    n_steps = 8 * max(args.steps // 8, 1)
    rays = cfg.num_rays_lidar + (cfg.num_rays if cfg.enable_rgb else 0)
    print(json.dumps({"rung": tag, "steps": n_steps,
                      "ms_per_step": round(dt / n_steps * 1e3, 1),
                      "rays_per_sec": round(rays * n_steps / dt, 1)}))
    summarize(args.dir)


if __name__ == "__main__":
    main()
