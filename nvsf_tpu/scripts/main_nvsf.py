"""CLI entry point — training / evaluation / testing / novel-sensor synthesis.

Keeps the reference CLI surface (``nvsf/scripts/main_nvsf.py``): same flags,
config txt files, and train/test_eval branches.

Usage:
  python -m nvsf_tpu.scripts.main_nvsf --config configs/kitti360_1908.txt
  python -m nvsf_tpu.scripts.main_nvsf --config ... --test_eval --use_refine
  python -m nvsf_tpu.scripts.main_nvsf --config ... --test \
      --delta_position 0 0 1 --V_lidar_ch 32      # novel sensor
"""

from __future__ import annotations

import os
import time

import numpy as np

from nvsf_tpu.config import NVSFConfig, load_config


def seed_everything(seed: int):
    import random
    random.seed(seed)
    np.random.seed(seed)


def _load_scene(cfg, split, novel_sensor=None):
    if cfg.dataloader == "synthetic":
        from nvsf_tpu.data.synthetic import (SyntheticSceneSpec,
                                             make_synthetic_scene)
        spec = SyntheticSceneSpec(num_frames=cfg.num_frames, scale=cfg.scale)
        return make_synthetic_scene(spec, split=split)
    from nvsf_tpu.data.kitti360 import load_kitti360_scene
    return load_kitti360_scene(cfg, split, novel_sensor=novel_sensor)


def _novel_sensor_dict(cfg):
    ns = {
        "delta_position": cfg.delta_position,
        "delta_orientation": cfg.delta_orientation,
        "H_lidar_new": cfg.V_lidar_ch,
        "W_lidar_new": cfg.H_lidar_ch,
        "intrinsics_lidar_new": cfg.intrinsics_lidar_new,
        "intrinsics_hoz_lidar_new": cfg.intrinsics_hoz_lidar_new,
        "delta_pos_camera": cfg.delta_pos_camera,
        "delta_orient_camera": cfg.delta_orient_camera,
        "H_new": cfg.H_new, "W_new": cfg.W_new,
    }
    changed = (any(np.any(np.asarray(v)) for v in (
        cfg.delta_position, cfg.delta_orientation, cfg.delta_pos_camera,
        cfg.delta_orient_camera, cfg.intrinsics_lidar_new,
        cfg.intrinsics_hoz_lidar_new))
        or cfg.V_lidar_ch or cfg.H_lidar_ch or cfg.H_new or cfg.W_new)
    return ns if changed else None


def main(argv=None):
    cfg = load_config(argv)
    seed_everything(cfg.seed)
    os.makedirs(cfg.workspace, exist_ok=True)
    # args dump (``main_nvsf.py:151-156``)
    with open(os.path.join(cfg.workspace, f"args_{cfg.name}.txt"), "w") as f:
        for k, v in cfg.to_dict().items():
            f.write(f"{k} = {v}\n")

    from nvsf_tpu.train.evaluate import evaluate
    from nvsf_tpu.train.trainer import Trainer
    from nvsf_tpu.parallel.mesh import make_mesh, mesh_from_spec
    from nvsf_tpu.compile_cache import enable_compile_cache
    import jax

    enable_compile_cache()

    mesh = None
    if cfg.mesh_shape:
        mesh = mesh_from_spec(cfg.mesh_shape)
    elif len(jax.devices()) > 1:
        mesh = make_mesh()

    if cfg.test or cfg.test_eval:
        ns = _novel_sensor_dict(cfg)
        cfg_run = cfg.finalize(steps_per_epoch=1)
        test_scene = _load_scene(cfg_run, "test", novel_sensor=ns)
        train_scene_stub = test_scene  # trainer binds to a scene for shapes
        trainer = Trainer(cfg_run, train_scene_stub,
                          workspace=cfg_run.workspace, mesh=mesh)
        if not trainer.load_checkpoint(cfg_run.ckpt,
                                       prefer_refine=cfg_run.use_refine):
            raise FileNotFoundError(
                f"no checkpoint '{cfg_run.ckpt}' in {cfg_run.workspace}")
        results_dir = os.path.join(cfg_run.workspace, "results")
        if test_scene.has_gt and cfg_run.test_eval:
            evaluate(trainer, test_scene, use_refine=cfg_run.use_refine,
                     save_dir=results_dir, name=cfg_run.name,
                     write_outputs=True)
        # test: render + dump every frame even without GT
        from nvsf_tpu.train.test_mode import run_test
        run_test(trainer, test_scene, save_dir=results_dir,
                 name=cfg_run.name, use_refine=cfg_run.use_refine)
        # density mesh export (``main_nvsf.py:297-300``)
        from nvsf_tpu.render.export import export_mesh_density
        export_mesh_density(
            trainer, bound_min=tuple(cfg_run.mesh_bound_min),
            bound_max=tuple(cfg_run.mesh_bound_max),
            xyz_res=tuple(cfg_run.mesh_xyz_res),
            threshold=cfg_run.density_thresh,
            out_path=os.path.join(results_dir, f"{cfg_run.name}_mesh.ply"))
        return

    # ------------------------- training -------------------------
    train_scene = _load_scene(cfg, "train")
    cfg_run = cfg.finalize(steps_per_epoch=len(train_scene))
    val_scene = _load_scene(cfg_run, "val")
    trainer = Trainer(cfg_run, train_scene, workspace=cfg_run.workspace,
                      mesh=mesh)
    if cfg_run.ckpt != "scratch":
        trainer.load_checkpoint(cfg_run.ckpt)

    from nvsf_tpu.train.logging import (Logger, TensorboardWriter,
                                        model_summary, save_sampling_heatmap)
    log = Logger(cfg_run.workspace, cfg_run.name)
    tb = TensorboardWriter(cfg_run.workspace)
    log(f"[INFO] model parameters:\n"
        f"{model_summary(trainer.state['params'])}")

    t0 = time.time()

    def on_epoch(ep, stats):
        tb.add_scalar("train/loss", stats.loss, ep)
        tb.add_scalars_dict("train", stats.parts, ep)
        if ep % cfg_run.eval_interval == 0 or ep == cfg_run.epochs:
            trainer.save_checkpoint(full=True)
            log(f"[epoch {ep}] loss={stats.loss:.5f} "
                f"({(time.time() - t0) / 60:.1f} min)")
            if cfg_run.vis_training and "error_map" in trainer.state:
                save_sampling_heatmap(
                    np.asarray(trainer.state["error_map"])[len(train_scene)
                                                           // 2],
                    os.path.join(cfg_run.workspace, "validation",
                                 f"{cfg_run.name}_sampling_lidar_"
                                 f"{ep}.png"))
            results = evaluate(
                trainer, val_scene, use_refine=False,
                save_dir=os.path.join(cfg_run.workspace, "validation"),
                name=f"{cfg_run.name}_ep{ep:04d}", log_fn=log)
            for cat, r in results.items():
                tb.add_scalars_dict(f"eval_{cat}", {
                    k: (v[0] if isinstance(v, list) else v)
                    for k, v in r.items()}, ep)
            # best checkpoint keyed to chamfer distance
            # (``trainer.py:1786-1791``, ``utils.py:650-676``)
            comb = results.get("combined", {})
            cd = comb.get("point", [float("inf")])
            cd = cd[0] if isinstance(cd, list) else cd
            trainer.stats["results"].append(cd)
            best = trainer.stats.get("best_result")
            if cd == cd and (best is None or cd < best):
                trainer.stats["best_result"] = cd
                trainer.save_checkpoint(full=False, best=True)
                log(f"[epoch {ep}] new best CD {cd:.5f} -> best checkpoint")

    # epochs ride through recoverable device failures by restoring the
    # latest checkpoint (SURVEY §5 failure detection/recovery)
    from nvsf_tpu.train.resilience import run_epochs_with_recovery
    run_epochs_with_recovery(trainer, trainer.epoch + 1, cfg_run.epochs,
                             on_epoch, log_fn=log)
    # refine + refined eval (``trainer.py:1092-1096``)
    if cfg_run.enable_lidar:
        trainer.refine(steps=cfg_run.refine_steps, log_fn=log)
        evaluate(trainer, val_scene, use_refine=True,
                 save_dir=os.path.join(cfg_run.workspace, "validation"),
                 name=f"{cfg_run.name}_ep{trainer.epoch:04d}_refined",
                 log_fn=log)
    log(f"==> Training finished in {(time.time() - t0) / 60:.2f} minutes")
    tb.close()
    log.close()


if __name__ == "__main__":
    main()
