#!/usr/bin/env python3
"""Smoke test of the joint LiDAR+camera trainer on an NVIDIA GPU.

Runs the system's main path once, in ONE process, through the API that
``nvsf_tpu.scripts.main_nvsf`` drives, on a synthetic scene at KITTI-360
geometry (66x1030 LiDAR pano, 94x352 camera, 16 frames) with random
weights made from a seed:

  (a) train   flagship config (``configs/kitti360_1908.txt``) at full width:
              joint 2048+2048 rays, occupancy mode K=96/128, flow loss,
              error-map (patch) epochs, bf16; two epochs, crossing an
              occupancy refresh; the loss must be finite and drop
  (b) ref     the random-ray epochs at the reference encoder shape (8x4
              hash, 16x8 flow)
  (c) eval    ``evaluate()`` on one held-out frame (eval chamfer at ~68k x
              68k points, PSNR, depth metrics), then one full 66x1030
              ``render_lidar_frame``
  (d) ckpt    full checkpoint save + load, bit-exact parameter round trip
  (e) compare each part on the GPU against a plain reference on the CPU
              device of the same process (float32 at "highest" matmul
              precision, or float64 numpy): one train step, the table
              gradient scatter, chamfer, the multi-corner plane sampler

``--four-cards`` runs only the ray-sharded joint step over a 4-card mesh
against one card at the same global batch, and a sharded pano render
against an unsharded one.

Each phase prints one line with its wall and compile time. The last line
of standard output is one JSON object, ``{"ok": true, "device": {...}}``,
printed only when every phase passed. Exits non-zero, with no such line,
when JAX finds no GPU or when any phase fails.

Usage (from the repository root, on a machine with the card):
  python chip_smoke.py
  python chip_smoke.py --four-cards
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "kitti360_1908.txt")
# synthetic scene at KITTI-360 geometry (LiDAR vertical FoV from the
# shipped config; depth to the 80 m far plane)
SCENE = dict(num_frames=16, H_lidar=66, W_lidar=1030, H=94, W=352,
             max_depth=80.0, intrinsics_lidar=(2.0, 26.9))
REF_ENCODER = ["--n_levels_hash", "8", "--n_features_per_level_hash", "4",
               "--flow_n_levels", "16", "--flow_n_features_per_level", "8"]


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ----------------------------------------------------------------------
# compile-time accounting: JAX reports tracing, lowering and backend
# compilation durations through jax.monitoring
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]
_programs = []          # (program name, seconds), from jax_log_compiles


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


class _CompileLog(logging.Handler):
    def emit(self, record):
        m = re.match(r"Finished XLA compilation of (.+) in ([0-9.]+) sec",
                     record.getMessage())
        if m:
            _programs.append((m.group(1), float(m.group(2))))


def log_compiles():
    """Record each program's compile time instead of printing JAX's
    compile log."""
    import jax
    jax.config.update("jax_log_compiles", True)
    for name in ("jax._src.dispatch", "jax._src.interpreters.pxla"):
        logger = logging.getLogger(name)
        logger.addHandler(_CompileLog())
        logger.propagate = False
    jax.monitoring.register_event_duration_secs_listener(_on_duration)


def run_phase(name, fn, results):
    n0 = len(_programs)
    c0, t0 = _compile_s[0], time.perf_counter()
    try:
        out = fn()
        ok = True
    except Exception:  # noqa: BLE001 — every phase runs; failures reported
        traceback.print_exc()
        out, ok = None, False
    wall = time.perf_counter() - t0
    slow = sorted(_programs[n0:], key=lambda p: -p[1])[:6]
    if slow:
        print("  slowest compiles: " + ", ".join(
            f"{n} {t:.1f}s" for n, t in slow))
    print(f"[phase] {name}: {'ok' if ok else 'FAILED'} wall_s={wall:.3f} "
          f"compile_s={_compile_s[0] - c0:.3f}", flush=True)
    results[name] = ok
    return out


# ----------------------------------------------------------------------
def flagship_config(workspace, *extra):
    """The shipped config with the dataloader switched to the synthetic
    scene; ``extra`` are CLI overrides."""
    from nvsf_tpu.config import load_config
    return load_config(["--config", CONFIG, "--dataloader", "synthetic",
                        "--num_frames", str(SCENE["num_frames"]),
                        "--offset", "0", "0", "0",
                        "--workspace", workspace, *extra])


def make_scene(cfg, split):
    from nvsf_tpu.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
    return make_synthetic_scene(SyntheticSceneSpec(**SCENE, scale=cfg.scale),
                                split=split)


def build_trainer(workspace, *extra, fp16=True, mesh=None):
    from nvsf_tpu.train.trainer import Trainer
    cfg = flagship_config(workspace, *extra)
    cfg = dataclasses.replace(cfg, fp16=fp16)
    scene = make_scene(cfg, "train")
    cfg = cfg.finalize(steps_per_epoch=len(scene))
    return Trainer(cfg, scene, workspace=workspace, mesh=mesh)


def widths(cfg):
    return (f"hash {cfg.n_levels_hash}x{cfg.n_features_per_level_hash} "
            f"2^{cfg.log2_hashmap_size}, flow {cfg.flow_n_levels}x"
            f"{cfg.flow_n_features_per_level}, rays {cfg.num_rays_lidar}+"
            f"{cfg.num_rays}, K {cfg.num_steps_occ}/{cfg.num_steps_occ_rgb}, "
            f"bf16 {cfg.fp16}")


def train_epochs(tr, epochs):
    """Odd epochs sample random rays; even ones (change_patch_size_epoch)
    sample patches from the error map. Two epochs of 15 steps cross one
    occupancy refresh (occ_update_interval 16)."""
    losses = []
    for ep in epochs:
        tr.epoch = ep
        losses.append(tr.train_one_epoch().loss)
    print(f"  {widths(tr.cfg)}; {tr.global_step} steps, "
          f"{tr._occ_refresh_count} occupancy refreshes, epoch losses "
          f"{[round(x, 5) for x in losses]}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(tr._occ_refresh_count >= 1, "no occupancy refresh happened")
    check(losses[-1] < losses[0], f"loss did not drop: {losses}")
    return losses


def phase_train(ws):
    """Patch epochs only (2 and 4): error-map sampling at full width; the
    random-ray program is exercised by (b) and (e)."""
    tr = build_trainer(ws)
    train_epochs(tr, epochs=(2, 4))
    return tr


def phase_ref(ws):
    """Random-ray epochs only: the patch program was exercised in (a)."""
    tr = build_trainer(ws, *REF_ENCODER)
    train_epochs(tr, epochs=(1, 3))


def phase_eval(tr, ws):
    from nvsf_tpu.train.evaluate import evaluate
    val = make_scene(tr.cfg, "val")
    check(len(val) == 1, f"expected one held-out frame, got {len(val)}")
    res = evaluate(tr, val, name="smoke", save_dir=os.path.join(ws, "eval"),
                   write_outputs=True, log_fn=None)["combined"]
    cd, fscore = res["point"]
    print(f"  held-out frame: CD {cd:.5f} F@0.05 {fscore:.4f} depth "
          f"RMSE {res['depth'][0]:.4f} PSNR {res['rgb_psnr']:.3f}")
    check(np.isfinite(cd) and 0.0 <= fscore <= 1.0, f"point metrics {res}")
    check(np.isfinite(res["depth"][0]) and np.isfinite(res["rgb_psnr"]),
          f"depth/psnr {res}")
    out = tr.render_lidar_frame(0)
    shape = (SCENE["H_lidar"], SCENE["W_lidar"])
    for k, v in out.items():
        check(v.shape == shape and np.isfinite(v).all(),
              f"render {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
    print(f"  render_lidar_frame: {shape}, depth range "
          f"[{out['depth'].min():.4f}, {out['depth'].max():.4f}]")


def phase_ckpt(tr):
    import jax
    keys = ("params", "ema_params", "opt_state", "occ_grid_lidar",
            "occ_grid_rgb", "error_map", "error_map_rgb")
    before = {k: jax.device_get(tr.state[k]) for k in keys}
    path = tr.save_checkpoint(full=True)
    check(tr.load_checkpoint(path), f"could not load {path}")
    n = 0
    for k in keys:
        a = jax.tree.leaves(before[k])
        b = jax.tree.leaves(jax.device_get(tr.state[k]))
        check(len(a) == len(b), f"{k}: {len(a)} vs {len(b)} leaves")
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"{k}: leaf changed across save/load")
            n += x.size
    print(f"  {os.path.getsize(path) / 2**20:.1f} MiB, {n} values "
          f"bit-exact after save/load")


# ----------------------------------------------------------------------
# (e) comparisons against a plain reference
def rel_l2(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / max(np.linalg.norm(ref), 1e-30))


def report(name, value, tol, precision):
    ok = value <= tol
    print(f"  {name}: {value:.3e} (tol {tol:.0e}; {precision}) "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def _flat(tree):
    import jax
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree.leaves(tree)])


def compare_steps(tr_a, tr_b, place_b, label, loss_tol, grad_tol,
                  precision, highest_b=False, step_b=None):
    """One random-ray train step on two trainers from tr_a's state (moved
    with ``place_b`` for tr_b). Compares the loss; each parameter group's
    gradient, read from Adam's first moment (0.1 * grad after one step);
    and the updated parameters.

    Hash-table gradients are compared through per-row sums of g and |g|:
    a sample whose position differs by one float32 ulp between the two
    sides can land in the next cell of a fine level, which moves its
    contribution to another slot of the same row. Continuous groups are
    compared elementwise. Updated parameters are compared where the
    reference gradient is clearly nonzero (|g| >= 1% of its rms): there
    Adam's first step is +-lr * sign(g) on both sides.
    ``step_b(tr, state)`` replaces tr_b's jitted step.
    """
    import contextlib

    import jax
    import jax.numpy as jnp
    p0 = jax.device_get(tr_a.state["params"])
    tr_b.state = place_b(jax.device_get(tr_a.state))
    outs = []
    for tr in (tr_a, tr_b):
        prec = (jax.default_matmul_precision("highest")
                if tr is tr_b and highest_b else contextlib.nullcontext())
        with prec:
            if tr is tr_b and step_b is not None:
                st, m = step_b(tr, tr.state)
            else:
                st, m = tr._step_random(tr.state, jnp.int32(0))
        tr.state = st
        outs.append((jax.device_get(st), float(m["loss"])))
    (sa, la), (sb, lb) = outs
    ok = report(f"{label} loss {la:.6f} vs {lb:.6f}, rel err",
                abs(la - lb) / abs(lb), loss_tol, precision)
    mu_a, mu_b = sa["opt_state"][1].mu, sb["opt_state"][1].mu
    for group in ("hash_lidar", "hash_camera", "planes_lidar",
                  "planes_camera", "flow", "sigma_net"):
        if group.startswith("hash"):
            rows = [(_row_sums(mu_a[group], f), _row_sums(mu_b[group], f))
                    for f in (lambda g: g, np.abs)]
            ok &= report(f"{label} grad[{group}] per-row sums of g, |g|: "
                         "rel L2", max(rel_l2(a, b) for a, b in rows),
                         grad_tol, precision)
        else:
            ok &= report(f"{label} grad[{group}] rel L2",
                         rel_l2(_flat(mu_a[group]), _flat(mu_b[group])),
                         grad_tol, precision)
        g = _flat(mu_b[group])
        strong = np.abs(g) >= 1e-2 * np.sqrt(np.mean(g * g))
        same = np.abs(_flat(sa["params"][group])
                      - _flat(sb["params"][group])) <= 1e-6
        ok &= report(f"{label} updated {group}: share of {int(strong.sum())} "
                     "strong-gradient entries that differ",
                     float(1.0 - same[strong].mean()), 1e-2,
                     "Adam step +-lr on both sides")
    return ok


def _row_sums(tree, f):
    import jax
    return np.concatenate([
        f(np.asarray(x, np.float64)).reshape(-1, x.shape[-1]).sum(-1)
        for x in jax.tree.leaves(tree)])


def compare_train_step(ws, gpu, cpu, *extra):
    """GPU as the program runs it (float32, XLA's default TF32 matmuls)
    against the CPU at float32 "highest", from one state, bf16 off, at the
    flagship batch of 2048+2048 rays. The GPU program is also the 1-card
    side of ``--four-cards``, which finds it in the compile cache."""
    import jax
    with jax.default_device(gpu):
        tg = build_trainer(os.path.join(ws, "g"), *extra, fp16=False)
    with jax.default_device(cpu):
        tc = build_trainer(os.path.join(ws, "c"), *extra, fp16=False)
    print(f"  train step: {widths(tg.cfg)}")
    return compare_steps(tg, tc, lambda s: jax.device_put(s, cpu), "step",
                         1e-2, 2e-2, "GPU f32/TF32 vs CPU f32 highest",
                         highest_b=True)


def compare_segment_add(gpu, M=8_400_000, T=2 ** 21, F=8, seed=0):
    """Table-gradient scatter at the flagship fused hash shape against
    float64 ``np.add.at``. Tolerance: float32 sums of the slot's updates,
    relative to the sum of their magnitudes."""
    import jax
    import jax.numpy as jnp
    from nvsf_tpu.ops.segsum import segment_add_fm
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, T, M, dtype=np.int32)
    vals = rng.standard_normal((F, M), dtype=np.float32)
    got = np.asarray(jax.jit(segment_add_fm, static_argnums=2)(
        jax.device_put(jnp.asarray(cols), gpu),
        jax.device_put(jnp.asarray(vals), gpu), T))
    ref = np.zeros((T, F))
    np.add.at(ref, cols, vals.T.astype(np.float64))
    mag = np.zeros((T, F))
    np.add.at(mag, cols, np.abs(vals.T.astype(np.float64)))
    err = np.abs(got.T - ref) / (mag + 1e-30)
    return report(f"segment_add_fm M={M} T={T} F={F}: max |err| / sum|v|",
                  float(err[mag > 0].max()), 1e-6,
                  "GPU f32 atomics vs float64 np.add.at")


def compare_chamfer(gpu, seed=0):
    """Chamfer between one pano's LiDAR-frame points in metres (out to
    80 m) and a 5 cm-noisy copy, against float64 brute force on a subset of
    queries and scipy's exact float64 KD-tree on all of them."""
    import jax
    from scipy.spatial import cKDTree

    from nvsf_tpu.lib.convert import pano_to_lidar
    from nvsf_tpu.ops.chamfer import chamfer_distance
    from nvsf_tpu.data.synthetic import SyntheticSceneSpec, make_synthetic_scene

    spec = SyntheticSceneSpec(**dict(SCENE, num_frames=1), scale=1.0)
    pano = make_synthetic_scene(spec, split="all").images_lidar[0]
    gt = pano_to_lidar(pano[..., 2], SCENE["intrinsics_lidar"],
                       spec.intrinsics_hoz_lidar).astype(np.float64)
    rng = np.random.default_rng(seed)
    pred = gt + rng.normal(0.0, 0.05, gt.shape)
    a, b = pred.astype(np.float32), gt.astype(np.float32)
    with jax.default_device(gpu):
        d1, d2 = (np.asarray(x) for x in chamfer_distance(a, b))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    r1 = cKDTree(b64).query(a64)[0] ** 2
    r2 = cKDTree(a64).query(b64)[0] ** 2
    sub = rng.choice(len(a64), min(2048, len(a64)), replace=False)
    brute = np.concatenate([
        ((a64[s, None, :] - b64[None, :, :]) ** 2).sum(-1).min(1)
        for s in np.array_split(sub, 32)])
    ok = report("KD-tree vs brute force (float64), max |diff| m^2",
                float(np.abs(brute - r1[sub]).max()), 1e-12, "float64")
    err = max((np.abs(d1 - r1) / (1e-5 + 1e-6 * r1)).max(),
              (np.abs(d2 - r2) / (1e-5 + 1e-6 * r2)).max())
    ok &= report(f"chamfer {len(a)}x{len(b)} pts, max |d - d_ref| / "
                 "(1e-5 m^2 + 1e-6 d_ref)", float(err), 1.0,
                 "GPU f32 vs float64")
    f_got = _fscore(d1, d2)
    f_ref = _fscore(r1, r2)
    cd, cd_ref = d1.mean() + d2.mean(), r1.mean() + r2.mean()
    print(f"  CD {cd:.6f} vs {cd_ref:.6f}, F@0.05 {f_got:.5f} vs {f_ref:.5f}")
    ok &= report("chamfer CD rel err", abs(cd - cd_ref) / cd_ref, 1e-4,
                 "GPU f32 vs float64")
    ok &= report("F@0.05 abs err", abs(f_got - f_ref), 1e-3,
                 "GPU f32 vs float64")
    return ok


def _fscore(d1, d2, thr=0.05):
    p = float((np.sqrt(d1) < thr).mean())
    r = float((np.sqrt(d2) < thr).mean())
    return 2 * p * r / max(p + r, 1e-12)


def compare_multihot(gpu, Q=3, S=12, C=2, Np=196_608, F=8, W=256, seed=0):
    """The multi-corner plane sampler, forward and both gradients, at the
    flagship dynamic-plane shape (t-query + 2 warp queries, 4 scales x 3
    planes, 2048 rays x 96 samples) against an explicit float64 gather."""
    import jax
    import jax.numpy as jnp
    from nvsf_tpu.ops.multihot import multihot_sample
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((F, Q * S * W), dtype=np.float32)
    cols = rng.integers(0, W, (Q, S, C, Np), dtype=np.int32)
    ws = rng.uniform(size=(Q, S, C, Np)).astype(np.float32)
    g = rng.standard_normal((Q, S, F, Np), dtype=np.float32)

    def f(t, w):
        return multihot_sample(t, jnp.asarray(cols), w, W)

    with jax.default_device(gpu):
        out, vjp = jax.vjp(jax.jit(f), jnp.asarray(tables), jnp.asarray(ws))
        d_t, d_w = vjp(jnp.asarray(g))
    out, d_t, d_w = (np.asarray(x, np.float64) for x in (out, d_t, d_w))

    t64 = tables.astype(np.float64)
    gcols = cols + (np.arange(Q * S) * W).reshape(Q, S, 1, 1)
    v = t64[:, gcols]                                    # [F, Q, S, C, Np]
    ref = np.moveaxis((ws[None] * v).sum(3), 0, 2)       # [Q, S, F, Np]
    ref_dw = np.einsum("fqscn,qsfn->qscn", v, g.astype(np.float64))
    # d_tables[f, col] = sum of ws * g over the samples reading col
    flat = gcols.ravel()
    ref_dt = np.zeros((F, Q * S * W))
    mag = np.zeros((F, Q * S * W))
    for f in range(F):
        c = (ws * g[:, :, f, None, :]).astype(np.float64).ravel()
        ref_dt[f] = np.bincount(flat, c, minlength=Q * S * W)
        mag[f] = np.bincount(flat, np.abs(c), minlength=Q * S * W)
    label = f"multihot Q={Q} S={S} C={C} Np={Np} F={F} W={W}"
    ok = report(f"{label} forward max |err|", float(np.abs(out - ref).max()),
                1e-5, "GPU f32 vs float64 gather")
    ok &= report(f"{label} d_tables max |err| / sum|contrib|",
                 float((np.abs(d_t - ref_dt) / (mag + 1e-30))[mag > 0].max()),
                 1e-5, "GPU f32 atomics vs float64")
    ok &= report(f"{label} d_weights max |err|",
                 float(np.abs(d_w - ref_dw).max()), 1e-4,
                 "GPU f32 (8-term dot) vs float64")
    return ok


def phase_compare(ws, gpu, cpu):
    ok = compare_train_step(ws, gpu, cpu)
    ok &= compare_segment_add(gpu)
    ok &= compare_chamfer(gpu)
    ok &= compare_multihot(gpu)
    check(ok, "a comparison is outside its tolerance")


# ----------------------------------------------------------------------
# XLA's autotuning (picking the fastest of several GEMM and fusion
# variants) is about a third of a cold compile of the flagship step on the
# H100. The 4-card comparison compiles its sharded programs without it:
# that changes which kernel variant runs, not what it computes.
_NO_AUTOTUNE = {"xla_gpu_autotune_level": 0}


def phase_four_cards(ws):
    """Joint step ray-sharded over 4 cards vs one card at the same global
    batch (2048+2048 rays, bf16 off), then a sharded pano render vs an
    unsharded one (flagship config, bf16). The 1-card programs are the
    ones the 1-card run compiles, so they come from the compile cache when
    it persists."""
    import jax
    import jax.numpy as jnp
    from nvsf_tpu.parallel.mesh import make_mesh, replicate
    from nvsf_tpu.render.sweep import _lidar_sweep_fn, render_lidar_sweep
    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = make_mesh(4)
    t1 = build_trainer(os.path.join(ws, "one"), fp16=False)
    t4 = build_trainer(os.path.join(ws, "four"), fp16=False, mesh=mesh)
    print(f"  {widths(t1.cfg)}; mesh of {mesh.devices.size} cards")

    def sharded_step(tr, state):
        fi = jnp.int32(0)
        return tr._step_random.lower(state, fi).compile(_NO_AUTOTUNE)(
            state, fi)

    ok = compare_steps(t1, t4, lambda s: replicate(mesh, s), "4-card step",
                       1e-3, 1e-2, "f32 both, 1 card vs 4-card ray sharding",
                       step_b=sharded_step)
    tb = build_trainer(os.path.join(ws, "render"))
    sc, occ = tb.scene, tb._occ_kwargs(tb.state.get("occ_grid_lidar"),
                                       lidar=True)
    poses = np.asarray(sc.poses_lidar)[:1]
    times = np.asarray(sc.times, np.float32)[:1]
    one = render_lidar_sweep(
        tb.rend, tb.state["params"], poses, times, sc.H_lidar, sc.W_lidar,
        sc.intrinsics_lidar, sc.intrinsics_hoz_lidar, occ_kwargs=occ)
    fn = _lidar_sweep_fn(
        tb.rend, sc.H_lidar, sc.W_lidar, tuple(sc.intrinsics_lidar),
        tuple(sc.intrinsics_hoz_lidar), mesh, occ["occ_spec"],
        occ["num_steps_occ"], occ["occ_thresh"], True, occ["skip_warp"])
    args = (tb.state["params"], jnp.asarray(poses), jnp.asarray(times),
            occ["occ_grid"])
    four = fn.lower(*args).compile(_NO_AUTOTUNE)(*args)
    for k, a in zip(("depth", "raydrop", "intensity"), four):
        ok &= report(f"sharded pano render {k} rel L2",
                     rel_l2(np.asarray(a), one[k]), 1e-3,
                     "bf16 flagship config, 4-card vs 1-card")
    check(ok, "a four-card comparison is outside its tolerance")


# ----------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card ray-sharded path")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "nvsf_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax

    from nvsf_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX's default device is {devs[0]} "
              f"(platform {devs[0].platform})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    print(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind}",
          flush=True)
    log_compiles()

    results = {}
    ws = tempfile.mkdtemp(prefix="nvsf_smoke_")
    try:
        run_phases(args, ws, devs, results)
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    failed = [k for k, v in results.items() if not v]
    if failed or len(results) < (1 if args.four_cards else 5):
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if args.four_cards else 1}}))
    return 0


def run_phases(args, ws, devs, results):
    import jax
    if args.four_cards:
        run_phase("four_cards", lambda: phase_four_cards(ws), results)
    else:
        cpu = jax.devices("cpu")[0]
        tr = run_phase("a_train", lambda: phase_train(
            os.path.join(ws, "a")), results)
        if tr is not None:
            run_phase("c_eval", lambda: phase_eval(tr, ws), results)
            run_phase("d_ckpt", lambda: phase_ckpt(tr), results)
            del tr
        run_phase("b_ref_shape", lambda: phase_ref(
            os.path.join(ws, "b")), results)
        run_phase("e_compare", lambda: phase_compare(
            os.path.join(ws, "e"), devs[0], cpu), results)


if __name__ == "__main__":
    sys.exit(main())
