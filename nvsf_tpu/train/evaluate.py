"""Evaluation loop: full-frame renders, raydrop thresholding + optional U-Net
refinement, metric meters in three categories (combined / background /
foreground via 3D-annotation masks), JSON error matrices and artifact dumps.

Rebuilds ``nvsf/nerf/trainer.py:658-814`` (eval_step) and
``trainer.py:1458-1846`` (evaluate_one_epoch).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from nvsf_tpu.lib import convert, masks as masklib, metrics as M
from nvsf_tpu.lib.tools import write_png


def _lpips_meter(cfg):
    """One shared LPIPS instance per meter suite; weights resolve from the
    ``lpips_weights`` config flag, else the ``NVSF_TPU_LPIPS_WEIGHTS`` env
    var (LPIPSMeter's own fallback), else the meter reports NaN."""
    return M.LPIPSMeter(
        weights_path=getattr(cfg, "lpips_weights", "") or None)


def build_lidar_meters(cfg) -> Dict:
    """Meter suite per ``main_nvsf.py:224-232``."""
    return {
        "point": M.PointsMeter(scale=cfg.scale,
                               intrinsics=cfg.intrinsics_lidar,
                               intrinsics_hoz=cfg.intrinsics_hoz_lidar),
        "depth": M.DepthMeter_L4D(scale=cfg.scale,
                                  lpips_meter=_lpips_meter(cfg)),
        "intensity": M.IntensityMeter_L4D(scale=cfg.intensity_inv_scale,
                                          lpips_meter=_lpips_meter(cfg)),
        "raydrop": M.RaydropMeter(ratio=cfg.raydrop_ratio),
    }


def build_camera_meters(cfg) -> Dict:
    """Meter suite per ``main_nvsf.py:234-240``."""
    return {
        "rmse": M.RMSEMeter(rgb_metric=True),
        "psnr": M.PSNRMeter(),
        "lpips": _lpips_meter(cfg),
        "ssim": M.SSIMMeter(),
    }


def lidar_category_masks(pred_depth, gt_depth, pose_lidar, annotations, *,
                         scale, offset, intrinsics_lidar,
                         intrinsics_hoz_lidar, max_depth):
    """Per-category (pred_mask, gt_mask) pairs for the LiDAR meters.

    The reference computes a pred-derived AND a gt-derived object mask and
    applies each to ITS OWN operand — ``preds_depth * static_obj_mask_pred``
    vs ``gt_depth * static_obj_mask_gt``
    (``nvsf/nerf/trainer.py:1586-1626``) — so imperfect predicted depth
    cannot leak foreground pixels into the gt operand (or vice versa).

    ``annotations=None`` -> combined only (unannotated scene).
    ``annotations=[]`` (annotated scene, frame with zero boxes) -> the
    background mask is the full frame and foreground is empty, exactly the
    reference's else-branch (``trainer.py:1598-1626``) — such frames still
    update the category meters."""
    H, W = np.asarray(gt_depth).shape
    ones = np.ones((H, W), np.float32)
    cats = {"combined": (ones, ones)}
    if annotations is not None:
        kw = dict(scale=scale, offset=offset,
                  intrinsics_lidar=intrinsics_lidar,
                  intrinsics_hoz_lidar=intrinsics_hoz_lidar,
                  max_depth=max_depth)
        static_p, dyn_p = masklib.compute_object_masks_pano(
            pred_depth, pose_lidar, annotations, **kw)
        static_g, dyn_g = masklib.compute_object_masks_pano(
            gt_depth, pose_lidar, annotations, **kw)
        cats["background"] = (static_p, static_g)
        cats["foreground"] = (dyn_p, dyn_g)
    return cats


def _save_pano_png(path, arr, vmax=None):
    a = np.asarray(arr, np.float32)
    vmax = vmax or max(float(a.max()), 1e-8)
    write_png(path, (np.clip(a / vmax, 0, 1) * 255).astype(np.uint8))


def evaluate(trainer, scene, *, use_refine: bool = False, use_ema: bool = True,
             name: str = "eval", save_dir: Optional[str] = None,
             write_outputs: bool = False, log_fn=print) -> Dict[str, dict]:
    """Run the full eval over ``scene``; returns {category: {metric: value}}.

    Categories: 'combined' always; 'background'/'foreground' when the scene
    carries 3D annotations (``trainer.py:1538-1626``).
    """
    cfg = trainer.cfg
    has_ann = bool(scene.annotations)
    cats = ["combined"] + (["background", "foreground"] if has_ann else [])

    lidar_meters = {c: build_lidar_meters(cfg) for c in cats} \
        if cfg.enable_lidar else {}
    cam_meters = {c: build_camera_meters(cfg) for c in cats} \
        if cfg.enable_rgb else {}

    # pre-render every frame through the batched (mesh-sharded, occupancy
    # early-exit) sweep in small frame groups — one device dispatch per
    # group instead of the reference's per-frame host loop
    # (``trainer.py:1458-1526``)
    from nvsf_tpu.render.sweep import render_camera_sweep, render_lidar_sweep
    params = trainer.state["ema_params"] if use_ema \
        else trainer.state["params"]
    group = 4
    lidar_sw = {"depth": [], "raydrop": [], "intensity": []}
    cam_sw = {"rgb": [], "depth": []}
    for f0 in range(0, len(scene), group):
        fs = list(range(f0, min(f0 + group, len(scene))))
        if cfg.enable_lidar and scene.images_lidar is not None:
            sw = render_lidar_sweep(
                trainer.rend, params,
                np.asarray(scene.poses_lidar)[fs], np.asarray(scene.times)[fs],
                scene.H_lidar, scene.W_lidar, scene.intrinsics_lidar,
                scene.intrinsics_hoz_lidar, mesh=trainer.mesh,
                occ_kwargs=trainer._occ_kwargs(
                    trainer.state.get("occ_grid_lidar"), lidar=True))
            for k in lidar_sw:
                lidar_sw[k].extend(sw[k])
        if cfg.enable_rgb and scene.images is not None:
            sw = render_camera_sweep(
                trainer.rend, params,
                np.asarray(scene.poses)[fs], np.asarray(scene.times)[fs],
                scene.H, scene.W, scene.intrinsics, mesh=trainer.mesh,
                occ_kwargs=trainer._occ_kwargs(
                    trainer.state.get("occ_grid_rgb")))
            for k in cam_sw:
                cam_sw[k].extend(sw[k])

    for fi in range(len(scene)):
        ann = scene.annotations[fi] if has_ann else []
        # ---------------- LiDAR ----------------
        if cfg.enable_lidar and scene.images_lidar is not None:
            pred = {"depth": lidar_sw["depth"][fi],
                    "raydrop": lidar_sw["raydrop"][fi],
                    "intensity": lidar_sw["intensity"][fi]}
            pred_raydrop = pred["raydrop"]
            if cfg.raydrop_loss == "bce":
                pred_raydrop = 1.0 / (1.0 + np.exp(-pred_raydrop))
            if use_refine and trainer.has_unet:
                pred_raydrop = trainer.refine_raydrop_pano(
                    pred_raydrop, pred["intensity"], pred["depth"])
            rd_mask = (pred_raydrop > cfg.raydrop_thres).astype(np.float32)
            pred_int = pred["intensity"] * rd_mask
            pred_depth = pred["depth"] * rd_mask

            gt = scene.images_lidar[fi]
            gt_raydrop = gt[:, :, 0]
            gt_int = gt[:, :, 1] * gt_raydrop
            gt_depth = gt[:, :, 2] * gt_raydrop

            cat_masks = lidar_category_masks(
                pred_depth, gt_depth, scene.poses_lidar[fi],
                ann if has_ann else None,
                scale=cfg.scale, offset=cfg.offset,
                intrinsics_lidar=scene.intrinsics_lidar,
                intrinsics_hoz_lidar=scene.intrinsics_hoz_lidar,
                max_depth=cfg.lidar_max_depth / cfg.scale)
            for cat, (mp, mg) in cat_masks.items():
                mm = lidar_meters[cat]
                mm["point"].update(pred_depth * mp, gt_depth * mg)
                mm["depth"].update((pred_depth * mp)[None],
                                   (gt_depth * mg)[None])
                mm["intensity"].update((pred_int * mp)[None],
                                       (gt_int * mg)[None])
                mm["raydrop"].update(pred_raydrop * mp, gt_raydrop * mg)

            if write_outputs and save_dir:
                os.makedirs(save_dir, exist_ok=True)
                _save_pano_png(os.path.join(
                    save_dir, f"{name}_{fi:04d}_depth.png"), pred_depth)
                _save_pano_png(os.path.join(
                    save_dir, f"{name}_{fi:04d}_intensity.png"), pred_int,
                    vmax=1.0)
                pts = convert.pano_to_lidar_with_intensities(
                    pred_depth / cfg.scale, pred_int,
                    scene.intrinsics_lidar, scene.intrinsics_hoz_lidar)
                np.savetxt(os.path.join(
                    save_dir, f"{name}_{fi:04d}_pcd_lidar.txt"), pts,
                    fmt="%.6f")
                # world-frame cloud + per-point depth-error cloud — the
                # reference's remaining eval artifacts
                # (``nvsf/nerf/trainer.py:1675-1712``,
                # ``utils.py:444-474`` get_pcd_bound_to_world,
                # ``error_matrices.py:517-546`` depth_error_ratio: clamp
                # both depths to [min,max] range then gt - pred, meters)
                pose = np.array(scene.poses_lidar[fi], np.float64)
                pose[:3, 3] = pose[:3, 3] / cfg.scale + \
                    np.asarray(cfg.offset)
                pw = (pose @ np.column_stack(
                    [pts[:, :3], np.ones(len(pts))]).T).T[:, :3]
                np.savetxt(os.path.join(
                    save_dir, f"{name}_{fi:04d}_pcd_world.txt"),
                    np.column_stack([pw, pts[:, 3]]), fmt="%f")
                max_m = cfg.lidar_max_depth / cfg.scale
                err_pano = (np.clip(gt_depth / cfg.scale, 1e-3, max_m)
                            - np.clip(pred_depth / cfg.scale, 1e-3, max_m))
                err_pts = convert.pano_to_lidar_with_intensities(
                    pred_depth / cfg.scale, err_pano,
                    scene.intrinsics_lidar, scene.intrinsics_hoz_lidar)
                err_w = (pose @ np.column_stack(
                    [err_pts[:, :3], np.ones(len(err_pts))]).T).T[:, :3]
                np.savetxt(os.path.join(
                    save_dir, f"{name}_{fi:04d}_pcd_error_world.txt"),
                    np.column_stack([err_w, err_pts[:, 3]]), fmt="%f")

        # ---------------- camera ----------------
        if cfg.enable_rgb and scene.images is not None:
            out = {"rgb": cam_sw["rgb"][fi], "depth": cam_sw["depth"][fi]}
            pred_rgb = out["rgb"]
            gt_rgb = scene.images[fi][..., :3]
            cat_masks = {"combined": np.ones(gt_rgb.shape[:2])}
            if has_ann:
                st, dy = masklib.compute_object_masks_image(
                    scene.poses[fi], scene.intrinsics, ann, scene.H, scene.W,
                    scale=cfg.scale, offset=cfg.offset)
                cat_masks["background"] = st.astype(np.float32)
                cat_masks["foreground"] = dy.astype(np.float32)
            for cat, m in cat_masks.items():
                mm = cam_meters[cat]
                pm = pred_rgb * m[..., None]
                gm = gt_rgb * m[..., None]
                mm["psnr"].update(pm, gm)
                mm["ssim"].update(pm[None], gm[None])
                mm["lpips"].update(pm, gm)
                if scene.image_depths is not None:
                    mm["rmse"].update(out["depth"][..., None] / cfg.scale,
                                      scene.image_depths[fi])
            if write_outputs and save_dir:
                write_png(
                    os.path.join(save_dir, f"{name}_{fi:04d}_rgb.png"),
                    (np.clip(pred_rgb, 0, 1) * 255).astype(np.uint8))

    # ---------------- reports ----------------
    results = {}
    for cat in cats:
        r = {}
        if cfg.enable_lidar and lidar_meters:
            for k, meter in lidar_meters[cat].items():
                v = meter.measure()
                r[k] = v.tolist() if isinstance(v, np.ndarray) else float(v)
        if cfg.enable_rgb and cam_meters:
            for k, meter in cam_meters[cat].items():
                v = meter.measure()
                r[f"rgb_{k}"] = v.tolist() if isinstance(v, np.ndarray) \
                    else float(v)
        results[cat] = r
        if save_dir:
            all_meters = {}
            if cfg.enable_lidar and lidar_meters:
                all_meters.update(lidar_meters[cat])
            if cfg.enable_rgb and cam_meters:
                all_meters.update(
                    {f"rgb_{k}": v for k, v in cam_meters[cat].items()})
            M.write_error_matrix(
                all_meters,
                os.path.join(save_dir, f"{name}_error_matrix_{cat}.json"),
                extra={"epoch": trainer.epoch, "category": cat})
        if log_fn:
            log_fn(f"[eval:{cat}] " + " ".join(
                f"{k}={np.round(v, 4)}" for k, v in r.items()))
    return results
