"""Trainer: jitted train step (on-device ray sampling + rendering + losses +
error-map EMA), per-epoch EMA, eval, checkpointing.

Rebuilds ``nvsf/nerf/trainer.py`` as jitted device programs:
  - the whole step — pixel sampling (random / error-map / patch), GT gather,
    rendering, all losses, Adam update, error-map scatter — is ONE jitted
    function per sampling mode; the reference does sampling host-side in the
    DataLoader and round-trips losses to CPU every step
    (``trainer.py:552-630``).
  - optimizer: Adam(0.9, 0.99, eps=1e-15) with per-module LR groups (flow /
    intensity / raydrop at 0.1x — ``network_dynamic.py:335-357``) and the
    LambdaLR decay ``0.1 ** (step / iters)`` (``main_nvsf.py:360-362``),
    plus ``optax.zero_nans`` as the analogue of the reference's NaN scrub.
  - EMA(decay=0.95) updated once per epoch (``trainer.py:1420-1421``).
  - patch/random epoch alternation every ``change_patch_size_epoch`` epochs,
    error-map sampling only on patch epochs (``trainer.py:1054-1069``).
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nvsf_tpu.config import NVSFConfig
from nvsf_tpu.data import sampler
from nvsf_tpu.data.dataset import SceneData
from nvsf_tpu.lib import convert
from nvsf_tpu.lib import pointcloud as pclib
from nvsf_tpu.lib import rays as raylib
from nvsf_tpu.models.field import NVSFFieldSpec
from nvsf_tpu.render.renderer import RendererSpec
from nvsf_tpu.train import checkpoint as ckpt
from nvsf_tpu.train import losses as L


def field_spec_from_config(cfg: NVSFConfig) -> NVSFFieldSpec:
    return NVSFFieldSpec(
        min_resolution=cfg.min_resolution,
        base_resolution=cfg.base_resolution,
        max_resolution=cfg.max_resolution,
        time_resolution=cfg.time_resolution,
        n_levels_plane=cfg.n_levels_plane,
        n_features_per_level_plane=cfg.n_features_per_level_plane,
        n_levels_hash=cfg.n_levels_hash,
        n_features_per_level_hash=cfg.n_features_per_level_hash,
        log2_hashmap_size=cfg.log2_hashmap_size,
        hash_size_dynamic=tuple(cfg.hash_size_dynamic),
        num_layers_flow=cfg.num_layers_flow,
        hidden_dim_flow=cfg.hidden_dim_flow,
        flow_n_levels=cfg.flow_n_levels,
        flow_n_features_per_level=cfg.flow_n_features_per_level,
        flow_base_resolution=cfg.flow_base_resolution,
        flow_max_resolution=cfg.flow_max_resolution,
        flow_log2_hashmap_size=cfg.flow_log2_hashmap_size,
        num_layers_sigma=cfg.num_layers_sigma,
        hidden_dim_sigma=cfg.hidden_dim_sigma,
        geo_feat_dim=cfg.geo_feat_dim,
        num_layers_lidar=cfg.num_layers_color,
        hidden_dim_lidar=cfg.hidden_dim_lidar,
        num_layers_color=cfg.num_layers_color,
        num_frames=cfg.num_frames,
        bound=cfg.bound,
        encoder_remat=cfg.encoder_remat)


def renderer_spec_from_config(cfg: NVSFConfig,
                              field: NVSFFieldSpec) -> RendererSpec:
    return RendererSpec(
        field=field, bound=cfg.bound, density_scale=cfg.density_scale,
        min_near=cfg.min_near, min_near_lidar=cfg.min_near_lidar,
        lidar_max_depth=cfg.lidar_max_depth,
        active_sensor=cfg.active_sensor, num_steps=cfg.num_steps,
        max_ray_batch=cfg.max_ray_batch,
        compute_dtype="bfloat16" if cfg.fp16 else cfg.compute_dtype,
        remat_chunks=cfg.remat_chunks,
        stream_slab=cfg.stream_slab,
        occ_jitter=cfg.occ_jitter,
        occ_delta_clamp=cfg.occ_delta_clamp)


def make_optimizer(cfg: NVSFConfig, field: NVSFFieldSpec, params):
    """Adam + per-module LR groups + 0.1^(t/T) decay + NaN zeroing."""
    labels = field.lr_labels(params)
    slow_mask = jax.tree.map(lambda lbl: lbl == "slow", labels)

    def sched(step):
        return cfg.lr * 0.1 ** jnp.minimum(step / max(cfg.iters, 1), 1.0)

    return optax.chain(
        optax.zero_nans(),
        optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-15),
        optax.masked(optax.scale(0.1), slow_mask),
        optax.scale_by_schedule(lambda s: -sched(s)),
    )


@dataclass
class EpochStats:
    loss: float
    parts: Dict[str, float]


class Trainer:
    """Host-side orchestration around the jitted step functions."""

    def __init__(self, cfg: NVSFConfig, scene: SceneData,
                 workspace: Optional[str] = None, name: Optional[str] = None,
                 seed: int = 0, mesh=None):
        self.cfg = cfg
        self.scene = scene
        self.mesh = mesh  # jax.sharding.Mesh for ray-sharded DP (or None)
        self.name = name or cfg.name
        self.workspace = workspace or cfg.workspace
        os.makedirs(self.workspace, exist_ok=True)

        self.field = field_spec_from_config(cfg)
        self.rend = renderer_spec_from_config(cfg, self.field)
        if mesh is not None:
            # re-assert ray sharding at the renderer's sample-flatten
            # points: keeps encoder activations shard-local through the
            # fwd/bwd reshapes (see parallel.mesh.sample_shard_hint)
            from nvsf_tpu.parallel.mesh import sample_shard_hint
            object.__setattr__(self.rend, "shard_hint",
                               sample_shard_hint(mesh))

        # ---------------- device-resident frame data ----------------
        # GT arrays are None on novel-sensor scenes (the overrides
        # invalidate them, ``base_dataset.py:170-227``); the trainer must
        # still construct for test/synthesis rendering — only training
        # (which gathers GT) requires them.
        d = {}
        d["times"] = jnp.asarray(scene.times)
        if cfg.enable_lidar:
            d["poses_lidar"] = jnp.asarray(scene.poses_lidar)
            if scene.images_lidar is not None:
                d["panos"] = jnp.asarray(scene.images_lidar)  # [F,Hl,Wl,3]
                d["panos_flat"] = d["panos"].reshape(len(scene), -1, 3)
                # supervision-truncation guard: GT depths (scaled) beyond
                # the LiDAR far plane can never be rendered — depth loss
                # floors at |far - gt| and raydrop "paints" onto whatever
                # geometry fits. A config whose far plane cuts off real
                # returns is near-certainly mis-scaled (e.g. the r5-found
                # double-scaling: meter near/fars passed through
                # finalize() a second time -> far = 80*scale^2 ~ 1 world
                # meter, the actual cause of the r4 "production fog
                # collapse"). Hard-fail instead of silently collapsing.
                import numpy as _np
                _pan = _np.asarray(scene.images_lidar)
                _hit = _pan[..., 0] > 0.5
                if _hit.any():
                    _q99 = float(_np.quantile(_pan[..., 2][_hit], 0.99))
                    if _q99 > float(cfg.lidar_max_depth):
                        raise ValueError(
                            f"lidar_max_depth={cfg.lidar_max_depth:.4g} "
                            f"(scaled) truncates the GT depth "
                            f"distribution (p99={_q99:.4g}): "
                            ">=1% of returns lie beyond the far plane "
                            "and can never be supervised. Near/far are "
                            "scaled by NVSFConfig.finalize() exactly "
                            "once — pass METERS through finalize(), or "
                            "scaled values without it.")
                if (cfg.grad_norm_smooth or cfg.spatial_smooth
                        or cfg.tv_loss or cfg.grad_loss):
                    # GT-pano double gradients are a pure per-frame
                    # function — precompute once instead of re-deriving
                    # the full [Hl, Wl] maps inside every patch step
                    # (``trainer.py:398-411`` recomputes per step too)
                    from nvsf_tpu.train import losses as _L
                    gxx, gyy = jax.vmap(
                        lambda p: _L.pano_double_gradients(p[:, :, 2],
                                                           cfg.scale))(
                        d["panos"])
                    d["pano_gxx_flat"] = gxx.reshape(len(scene), -1)
                    d["pano_gyy_flat"] = gyy.reshape(len(scene), -1)
        if cfg.enable_rgb and scene.poses is not None:
            d["poses"] = jnp.asarray(scene.poses)
            if scene.images is not None:
                d["images_flat"] = jnp.asarray(scene.images.reshape(
                    len(scene), -1, scene.images.shape[-1]))
            if scene.image_depths is not None:
                d["image_depths_flat"] = jnp.asarray(
                    scene.image_depths.reshape(len(scene), -1))
            d["intrinsics"] = jnp.asarray(scene.intrinsics, jnp.float32)
        self.data = d

        # flow-loss point clouds (padded; ``trainer.py:1848-1912``) —
        # GT-derived, so skipped (like every loss) on GT-less scenes
        self.pc_data = None
        if cfg.flow_loss and cfg.enable_lidar \
                and scene.images_lidar is not None:
            self.pc_data = self._process_pointclouds()

        # occupancy grids (one per enabled branch) for accelerated rendering
        self.occ_spec = None
        if cfg.render_mode == "occupancy":
            from nvsf_tpu.ops.occupancy import OccupancyGridSpec
            self.occ_spec = OccupancyGridSpec(
                grid_size=cfg.occ_grid_size, bound=cfg.bound,
                decay=cfg.occ_decay,
                update_fraction=cfg.occ_update_fraction)

        # ---------------- train state ----------------
        key = jax.random.PRNGKey(seed)
        key, kp = jax.random.split(key)
        params = self.field.init(kp)
        self.tx = make_optimizer(cfg, self.field, params)
        Hl, Wl = scene.H_lidar, scene.W_lidar
        state = {
            "params": params,
            "opt_state": self.tx.init(params),
            # fresh buffers (donation would otherwise alias params)
            "ema_params": jax.tree.map(lambda x: x + 0, params),
            "key": key,
            "step": jnp.zeros((), jnp.int32),
        }
        if cfg.enable_lidar:
            # coarse error map at half pano res (``base_dataset.py:245``),
            # one per loaded frame (indexed by dataset row)
            state["error_map"] = jnp.ones(
                (len(scene), Hl // 2, Wl // 2), jnp.float32)
        if cfg.enable_rgb:
            # quarter image res (``base_dataset.py:246``)
            state["error_map_rgb"] = jnp.ones(
                (len(scene), scene.H // 4, scene.W // 4), jnp.float32)
        if self.occ_spec is not None:
            if cfg.enable_lidar:
                state["occ_grid_lidar"] = self.occ_spec.init()
            if cfg.enable_rgb:
                state["occ_grid_rgb"] = self.occ_spec.init()
        self.state = state
        self.epoch = 0
        self.global_step = 0
        self.stats = {"results": [], "best_result": None}
        # seeded epoch-order RNG: the last nondeterminism in an otherwise
        # fully keyed pipeline (exact-repro training runs)
        self._order_rng = np.random.default_rng(seed)

        # jitted step per sampling mode; the scan variant runs a whole epoch
        # (a sequence of frame indices) in ONE device dispatch — essential
        # when host<->device dispatch latency is non-trivial
        self._step_random = jax.jit(self._make_train_step(patch=False),
                                    donate_argnums=(0,))
        self._scan_random = jax.jit(
            self._make_epoch_scan(patch=False), donate_argnums=(0,))
        patch = tuple(cfg.change_patch_size_lidar)
        if patch and patch[0] > 1:
            self._step_patch = jax.jit(self._make_train_step(patch=True),
                                       donate_argnums=(0,))
            self._scan_patch = jax.jit(self._make_epoch_scan(patch=True),
                                       donate_argnums=(0,))
        else:
            self._step_patch = None
            self._scan_patch = None
        self._update_ema = jax.jit(
            lambda ema, p: jax.tree.map(
                lambda e, q: cfg.ema_decay * e + (1 - cfg.ema_decay) * q,
                ema, p))
        # host-triggered occupancy refresh at the instant-ngp cadence, as
        # its own dispatch between scan chunks (not a lax.cond in the step)
        if self.occ_spec is not None:
            def _occ_upd(params, grid, kk, ts, lidar):
                # warp-free density: ~3x cheaper per refresh; occupancy
                # only thresholds sigma against a decayed max
                return self.occ_spec.update(
                    grid, kk,
                    lambda p, t: self.field.density(
                        params, p, t, cal_lidar_color=lidar,
                        skip_warp=True)["sigma"],
                    thresh=cfg.occ_thresh, times=ts)
            self._occ_update = jax.jit(_occ_upd, static_argnums=(4,))
            # tick 0 counts as "already refreshed": the first refresh fires
            # once global_step crosses occ_update_interval, regardless of
            # dispatch chunking (max_dispatch_steps adds chunk boundaries
            # BELOW the interval, which must not trigger an early refresh)
            self._last_occ_update = 0
            self._occ_refresh_count = 0
        self._eval_lidar = jax.jit(self._render_frame_lidar)
        self._eval_camera = jax.jit(self._render_frame_camera)
        self._render_cache = {}
        self._profiled = False

        # U-Net ray-drop refiner (``network_dynamic.py:192``); trained only
        # in the refine stage
        from nvsf_tpu.models.unet import UNetSpec
        self.unet_spec = UNetSpec(in_channels=3, channels=32, out_channels=1)
        key, ku = jax.random.split(self.state["key"])
        self.state["key"] = key
        up, us = self.unet_spec.init(ku)
        self.state["unet_params"] = up
        self.state["unet_stats"] = us
        self.unet_trained = False

    # ------------------------------------------------------------------
    def _process_pointclouds(self):
        """pano -> lidar -> ground removal -> scaled world clouds, padded to
        fixed shape per global frame index (``trainer.py:1848-1912``)."""
        cfg, scene = self.cfg, self.scene
        F = scene.num_frames
        clouds = [np.zeros((0, 3), np.float32)] * F
        valid = np.zeros(F, bool)
        for i in range(len(scene)):
            pano = scene.images_lidar[i]
            gt_depth = pano[:, :, 2] * pano[:, :, 0] / cfg.scale
            pts = convert.pano_to_lidar(gt_depth, scene.intrinsics_lidar,
                                        scene.intrinsics_hoz_lidar)
            points, _ground = pclib.point_removal(
                pts, dist_min=1.0,
                dist_max=0.75 * cfg.lidar_max_depth / cfg.scale,
                z_limit=[-2.5, 4])
            pose = scene.poses_lidar[i]
            pw = points * cfg.scale
            pw = (pose @ np.hstack(
                [pw, np.ones((len(pw), 1), np.float32)]).T).T[:, :3]
            gfi = int(round(float(scene.times[i]) * (cfg.num_frames - 1)))
            clouds[gfi] = pw.astype(np.float32)
            valid[gfi] = True
        arr, mask = pclib.pad_pointclouds(clouds)
        return {"pc": jnp.asarray(arr), "pc_mask": jnp.asarray(mask),
                "pc_valid": jnp.asarray(valid)}

    # ------------------------------------------------------------------
    def _make_train_step(self, patch: bool):
        cfg = self.cfg
        scene = self.scene
        rend = self.rend
        field = self.field
        data = self.data
        pc_data = self.pc_data
        Hl, Wl = scene.H_lidar, scene.W_lidar
        H, W = scene.H, scene.W
        patch_hw = tuple(cfg.change_patch_size_lidar) if patch else (1, 1)
        use_error_map = cfg.use_error_map and patch
        criterion = {
            "rgb": L.make_criterion(cfg.rgb_loss, cfg.scale),
            "depth": L.make_criterion(cfg.depth_loss, cfg.scale),
            "rgb_depth": L.make_criterion(cfg.rgb_depth_loss, cfg.scale),
            "raydrop": L.make_criterion(cfg.raydrop_loss, cfg.scale),
            "intensity": L.make_criterion(cfg.intensity_loss, cfg.scale),
            "grad": L.make_criterion(cfg.depth_grad_loss, cfg.scale),
        }
        sr_flags = {
            "grad_norm_smooth": cfg.grad_norm_smooth,
            "spatial_smooth": cfg.spatial_smooth,
            "tv_loss": cfg.tv_loss,
            "grad_loss": cfg.grad_loss,
            "sobel_grad": cfg.sobel_grad,
            "depth_grad_loss_is_cos": cfg.depth_grad_loss == "cos",
            "alpha_grad_norm": cfg.alpha_grad_norm,
            "alpha_spatial": cfg.alpha_spatial,
            "alpha_tv": cfg.alpha_tv,
            "alpha_grad": cfg.alpha_grad,
        }

        joint = cfg.enable_lidar and cfg.enable_rgb and cfg.joint_fusion
        if joint:
            # the experimental fused path evaluates BOTH branches in one
            # density batch: per-branch sample budgets and the chunked
            # remat query don't exist there — refuse configs that would
            # silently train differently from the (default) separate path
            if cfg.num_steps_occ_rgb and \
                    cfg.num_steps_occ_rgb != cfg.num_steps_occ:
                raise ValueError(
                    "joint_fusion=True fuses both branches into one density "
                    f"batch and cannot honor num_steps_occ_rgb="
                    f"{cfg.num_steps_occ_rgb} != num_steps_occ="
                    f"{cfg.num_steps_occ}; unset num_steps_occ_rgb or "
                    "disable joint_fusion")
            if cfg.remat_chunks > 1:
                raise ValueError(
                    "joint_fusion=True bypasses the remat_chunks chunked "
                    "density query (run_joint evaluates the full joint "
                    "batch); set remat_chunks=1 or disable joint_fusion")

        def step_fn(state, fi):
            key = state["key"]
            key, k_li, k_ci, k_pl, k_pc, k_bg = jax.random.split(key, 6)
            t = data["times"][fi]
            parts = {}

            def loss_fn(params):
                total = 0.0
                aux = {}
                # ---------------- ray sampling (both branches) ----------
                if cfg.enable_lidar:
                    em = (state["error_map"][fi] if use_error_map else None)
                    inds = sampler.sample_indices(
                        k_li, Hl, Wl, cfg.num_rays_lidar,
                        patch_size=patch_hw if patch else 1,
                        error_map=em, use_error_map=use_error_map)
                    pose = data["poses_lidar"][fi]
                    ro, rd = raylib.get_lidar_rays(
                        pose, inds, Hl, Wl, scene.intrinsics_lidar,
                        scene.intrinsics_hoz_lidar)
                    gt = data["panos_flat"][fi][inds]        # [N, 3]
                    if self.mesh is not None:
                        from nvsf_tpu.parallel.mesh import shard_rays
                        ro, rd, gt = shard_rays(self.mesh, ro, rd, gt)
                if cfg.enable_rgb:
                    em_c = (state["error_map_rgb"][fi] if use_error_map
                            else None)
                    inds_c = sampler.sample_indices(
                        k_ci, H, W, cfg.num_rays,
                        patch_size=cfg.patch_size,
                        error_map=em_c, use_error_map=use_error_map)
                    pose_c = data["poses"][fi]
                    ro_c, rd_c = raylib.get_camera_rays(
                        pose_c, inds_c, H, W, data["intrinsics"])
                    gt_rgb = data["images_flat"][fi][inds_c]
                    if cfg.color_space == "linear":
                        from nvsf_tpu.lib.color import srgb_to_linear
                        gt_rgb = gt_rgb.at[..., :3].set(
                            srgb_to_linear(gt_rgb[..., :3]))
                    if self.mesh is not None:
                        from nvsf_tpu.parallel.mesh import shard_rays
                        ro_c, rd_c, gt_rgb = shard_rays(self.mesh, ro_c,
                                                        rd_c, gt_rgb)
                    if gt_rgb.shape[-1] == 4:
                        bg = jax.random.uniform(k_bg, (cfg.num_rays, 3))
                        gt_rgb = gt_rgb[..., :3] * gt_rgb[..., 3:] \
                            + bg * (1 - gt_rgb[..., 3:])
                    else:
                        bg = 1.0

                # flow-loss cloud rides in the joint flow batch for free
                fl = None
                pc = pcm = gfi = None
                if cfg.flow_loss and pc_data is not None:
                    gfi = jnp.round(t * (cfg.num_frames - 1)) \
                        .astype(jnp.int32)
                    pc = pc_data["pc"][gfi]
                    pcm = pc_data["pc_mask"][gfi]

                # ---------------- rendering ----------------
                if joint:
                    out, out_c, extra = rend.run_joint(
                        params, ro, rd, ro_c, rd_c, t,
                        perturb=True, key=k_pl, bg_color=bg,
                        occ_spec=self.occ_spec,
                        occ_grid_l=state.get("occ_grid_lidar"),
                        occ_grid_c=state.get("occ_grid_rgb"),
                        num_steps_occ=cfg.num_steps_occ,
                        occ_thresh=cfg.occ_thresh,
                        x_flow_extra=pc)
                    fl = extra.get("flow_extra")
                else:
                    if cfg.enable_lidar:
                        if self.occ_spec is not None:
                            out = rend.run_occupancy(
                                params, ro, rd, t, self.occ_spec,
                                state["occ_grid_lidar"],
                                num_steps_occ=cfg.num_steps_occ,
                                cal_lidar_color=True, perturb=True,
                                key=k_pl, occ_thresh=cfg.occ_thresh)
                        else:
                            out = rend.run(params, ro, rd, t,
                                           cal_lidar_color=True,
                                           perturb=True, key=k_pl)
                    if cfg.enable_rgb:
                        if self.occ_spec is not None:
                            out_c = rend.run_occupancy(
                                params, ro_c, rd_c, t, self.occ_spec,
                                state["occ_grid_rgb"],
                                num_steps_occ=(cfg.num_steps_occ_rgb
                                               or cfg.num_steps_occ),
                                cal_lidar_color=False, perturb=True,
                                key=k_pc, bg_color=bg,
                                occ_thresh=cfg.occ_thresh)
                        else:
                            out_c = rend.run(params, ro_c, rd_c, t,
                                             cal_lidar_color=False,
                                             perturb=True, key=k_pc,
                                             bg_color=bg)
                    if cfg.enable_lidar and pc is not None:
                        fl = field.flow(params, pc, t)

                # ------------------- LiDAR losses -------------------
                if cfg.enable_lidar:
                    gt_raydrop = gt[:, 0]
                    gt_intensity = gt[:, 1] * gt_raydrop
                    gt_depth = gt[:, 2] * gt_raydrop
                    pred_raydrop = out["image_lidar"][:, 0]
                    pred_intensity = out["image_lidar"][:, 1] * gt_raydrop
                    pred_depth = out["depth_lidar"] * gt_raydrop
                    if cfg.raydrop_loss == "bce":
                        pred_raydrop = jax.nn.sigmoid(pred_raydrop)

                    lidar_loss, lparts = L.lidar_losses(
                        pred_raydrop, pred_intensity, pred_depth,
                        gt_raydrop, gt_intensity, gt_depth, criterion,
                        cfg.alpha_d, cfg.alpha_i, cfg.alpha_r,
                        cfg.smooth_factor)
                    aux.update(lparts)
                    total = total + lidar_loss.sum()

                    cd = L.lidar_chamfer_loss(rd, pred_depth, gt_depth,
                                              cfg.scale)
                    aux["chamfer"] = cd
                    total = total + cd

                    if cfg.flow_loss and pc_data is not None:
                        if fl is None:
                            fl = field.flow(params, pc, t)
                        fl_loss = 0.0
                        nxt = jnp.minimum(gfi + 1, cfg.num_frames - 1)
                        prv = jnp.maximum(gfi - 1, 0)
                        has_next = (gfi < cfg.num_frames - 1) \
                            & pc_data["pc_valid"][nxt]
                        has_prev = (gfi > 0) & pc_data["pc_valid"][prv]
                        fwd = L.flow_consistency_loss(
                            pc, pcm, pc_data["pc"][nxt],
                            pc_data["pc_mask"][nxt], fl["flow_forward"])
                        bwd = L.flow_consistency_loss(
                            pc, pcm, pc_data["pc"][prv],
                            pc_data["pc_mask"][prv], fl["flow_backward"])
                        fl_loss = jnp.where(has_next, fwd, 0.0) \
                            + jnp.where(has_prev, bwd, 0.0)
                        aux["flow"] = fl_loss
                        total = total + fl_loss

                    if cfg.use_urf_loss:
                        urf = L.urf_line_of_sight_loss(
                            out["weights"], out["z_vals"], gt_depth,
                            state["step"], cfg.iters)
                        aux["urf"] = urf
                        total = total + urf

                    if patch and (cfg.grad_norm_smooth or cfg.spatial_smooth
                                  or cfg.tv_loss or cfg.grad_loss):
                        ph, pw = patch_hw
                        npatch = cfg.num_rays_lidar // (ph * pw)
                        pd = (out["depth_lidar"] / cfg.scale) \
                            .reshape(npatch, ph, pw)
                        gd = (gt[:, 2] / cfg.scale).reshape(npatch, ph, pw)
                        grd = gt_raydrop.reshape(npatch, ph, pw)
                        flat_xx = data["pano_gxx_flat"][fi][inds] \
                            .reshape(npatch, ph, pw)
                        flat_yy = data["pano_gyy_flat"][fi][inds] \
                            .reshape(npatch, ph, pw)
                        gmx = (jnp.abs(flat_xx) < 0.05).astype(jnp.float32)
                        gmy = (jnp.abs(flat_yy) < 0.05).astype(jnp.float32)
                        sr = L.structural_regularizers(
                            pd, gd, grd, gmx, gmy, criterion["grad"],
                            sr_flags)
                        aux["loss_sr"] = sr
                        total = total + sr

                    aux["per_ray_lidar"] = jax.lax.stop_gradient(lidar_loss)
                    aux["inds_lidar"] = inds

                # ------------------- camera losses -------------------
                if cfg.enable_rgb:
                    rgb_l = cfg.alpha_rgb * criterion["rgb"](out_c["image"],
                                                             gt_rgb[..., :3])
                    aux["rgb"] = rgb_l.sum()
                    total = total + rgb_l.sum()
                    if cfg.use_rgbd_loss and "image_depths_flat" in data:
                        gt_d = data["image_depths_flat"][fi][inds_c] \
                            * cfg.scale
                        max_d = 80 * cfg.scale
                        gt_d = jnp.minimum(gt_d, max_d)
                        pd_c = jnp.minimum(out_c["depth"], max_d)
                        m = (gt_d > 0).astype(jnp.float32)
                        rd_l = cfg.alpha_rd * criterion["rgb_depth"](
                            pd_c * m, gt_d * m)
                        aux["rgb_d"] = rd_l.sum()
                        total = total + rd_l.sum()
                    aux["per_ray_rgb"] = jax.lax.stop_gradient(
                        rgb_l.sum(-1) if rgb_l.ndim > 1 else rgb_l)
                    aux["inds_rgb"] = inds_c

                total = L.scrub_loss(total)
                return total, aux

            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state["params"])
            updates, opt_state = self.tx.update(grads, state["opt_state"],
                                                state["params"])
            params = optax.apply_updates(state["params"], updates)

            new_state = dict(state)
            new_state.update(params=params, opt_state=opt_state, key=key,
                             step=state["step"] + 1)

            # NOTE: the occupancy-grid refresh is NOT in the step graph; it
            # runs as its own host-triggered dispatch at the instant-ngp
            # cadence (see _maybe_update_occ / train_one_epoch).
            if cfg.enable_lidar:
                new_state["error_map"] = state["error_map"].at[fi].set(
                    sampler.update_error_map(
                        state["error_map"][fi], aux.pop("inds_lidar"),
                        aux.pop("per_ray_lidar"), Hl, Wl))
            if cfg.enable_rgb:
                new_state["error_map_rgb"] = state["error_map_rgb"] \
                    .at[fi].set(sampler.update_error_map(
                        state["error_map_rgb"][fi], aux.pop("inds_rgb"),
                        aux.pop("per_ray_rgb"), H, W))
            metrics = {"loss": loss}
            metrics.update({k: v for k, v in aux.items()
                            if jnp.ndim(v) == 0})
            return new_state, metrics

        return step_fn

    def _make_epoch_scan(self, patch: bool):
        step_fn = self._make_train_step(patch)

        def epoch_fn(state, order):
            return jax.lax.scan(lambda s, fi: step_fn(s, fi), state, order)

        return epoch_fn

    # ------------------------------------------------------------------
    def _occ_kwargs(self, occ_grid, lidar=False):
        """Render kwargs enabling the occupancy-compacted early-exit
        marcher when the trainer runs in occupancy mode.

        ``lidar=True`` callers (pano/eval renders) honor the render-time
        budget ``cfg.num_steps_occ_render``; camera renders keep the
        training K."""
        if self.occ_spec is None or occ_grid is None:
            return {}
        if lidar:
            k = self.cfg.num_steps_occ_render or self.cfg.num_steps_occ
        else:
            k = self.cfg.num_steps_occ_rgb or self.cfg.num_steps_occ
        return dict(occ_spec=self.occ_spec, occ_grid=occ_grid,
                    num_steps_occ=k, occ_thresh=self.cfg.occ_thresh,
                    skip_warp=bool(self.cfg.render_skip_warp))

    def _render_frame_lidar(self, params, fi, occ_grid=None):
        scene, data = self.scene, self.data
        Hl, Wl = scene.H_lidar, scene.W_lidar
        inds = jnp.arange(Hl * Wl, dtype=jnp.int32)
        ro, rd = raylib.get_lidar_rays(data["poses_lidar"][fi], inds, Hl, Wl,
                                       scene.intrinsics_lidar,
                                       scene.intrinsics_hoz_lidar)
        out = self.rend.render(params, ro, rd, data["times"][fi],
                               cal_lidar_color=True, staged=True,
                               **self._occ_kwargs(occ_grid, lidar=True))
        return {"depth": out["depth_lidar"].reshape(Hl, Wl),
                "raydrop": out["image_lidar"][:, 0].reshape(Hl, Wl),
                "intensity": out["image_lidar"][:, 1].reshape(Hl, Wl)}

    def _render_frame_camera(self, params, fi, occ_grid=None):
        scene, data = self.scene, self.data
        H, W = scene.H, scene.W
        inds = jnp.arange(H * W, dtype=jnp.int32)
        ro, rd = raylib.get_camera_rays(data["poses"][fi], inds, H, W,
                                        data["intrinsics"])
        out = self.rend.render(params, ro, rd, data["times"][fi],
                               cal_lidar_color=False, staged=True,
                               bg_color=1.0, **self._occ_kwargs(occ_grid))
        return {"rgb": out["image"].reshape(H, W, 3),
                "depth": out["depth"].reshape(H, W)}

    # ------------------------------------------------------------------
    def train_one_epoch(self, order=None, use_scan: bool = True) -> EpochStats:
        # device-trace exactly one epoch — the first WARM one (epoch 2, or
        # epoch 1 when there is only one), so the trace shows steady-state
        # dispatches, not the cold compile
        if (self.cfg.profile_dir and not self._profiled
                and self.epoch >= min(self.cfg.epochs, 2)):
            from nvsf_tpu.train.profiler import device_trace
            self._profiled = True
            with device_trace(self.cfg.profile_dir):
                return self._train_one_epoch_impl(order, use_scan)
        return self._train_one_epoch_impl(order, use_scan)

    def _train_one_epoch_impl(self, order=None,
                              use_scan: bool = True) -> EpochStats:
        cfg = self.cfg
        n = len(self.scene)
        if order is None:
            order = self._order_rng.permutation(n)
        order = np.asarray(order, np.int32)
        # patch epochs: epoch % change_patch_size_epoch == 0, epochs count
        # from 1 (``trainer.py:1050-1064``)
        use_patch = (self._step_patch is not None
                     and cfg.change_patch_size_lidar[0] > 1
                     and self.epoch > 0
                     and self.epoch % cfg.change_patch_size_epoch == 0)
        if use_scan:
            scan = self._scan_patch if use_patch else self._scan_random
            # honor the instant-ngp occupancy refresh cadence MID-epoch:
            # a whole-epoch scan would stretch the effective refresh
            # interval to >= steps-per-epoch regardless of
            # occ_update_interval, so the epoch is split into dispatches
            # that end exactly on interval boundaries with a refresh
            # between them (the compiled scan is shape-cached, so at most
            # two program shapes: the interval length and the tail)
            interval = (cfg.occ_update_interval
                        if (self.occ_spec is not None
                            and cfg.occ_update_interval > 0) else 0)
            # dispatch chunk: refresh interval, optionally capped by
            # max_dispatch_steps (bounds one device program's length; the
            # refresh tick in _maybe_update_occ is keyed to global_step so
            # extra chunk boundaries do NOT change the refresh cadence)
            chunk = interval
            if cfg.max_dispatch_steps > 0:
                chunk = min(chunk or len(order), cfg.max_dispatch_steps)
            if chunk and len(order) > chunk:
                # FIXED chunk length: at most two compiled scan shapes
                # (chunk + tail) per epoch length. Refresh boundaries
                # then drift within one chunk of the exact global-step
                # multiple, which the tick logic tolerates — cadence is
                # what matters, not exact alignment.
                sums, count = {}, 0
                for i0 in range(0, len(order), chunk):
                    sub = order[i0:i0 + chunk]
                    self.state, metrics = scan(self.state, jnp.asarray(sub))
                    self.global_step += len(sub)
                    for k, v in metrics.items():
                        sums[k] = sums.get(k, 0.0) \
                            + float(np.sum(np.asarray(v)))
                    count += len(sub)
                    self._maybe_update_occ()
                parts = {k: v / count for k, v in sums.items()}
                tot = parts["loss"] * len(order)
            else:
                self.state, metrics = scan(self.state, jnp.asarray(order))
                self.global_step += len(order)
                parts = {k: float(np.mean(np.asarray(v)))
                         for k, v in metrics.items()}
                tot = parts["loss"] * len(order)
        else:
            step = self._step_patch if use_patch else self._step_random
            tot, parts = 0.0, {}
            for fi in order:
                self.state, metrics = step(self.state, jnp.int32(fi))
                self.global_step += 1
                tot += float(metrics["loss"])
                for k, v in metrics.items():
                    parts[k] = parts.get(k, 0.0) + float(v)
                self._maybe_update_occ()
            parts = {k: v / len(order) for k, v in parts.items()}
        self.state["ema_params"] = self._update_ema(
            self.state["ema_params"], self.state["params"])
        self._maybe_update_occ()
        return EpochStats(loss=tot / len(order), parts=parts)

    def _occ_refresh_times(self, key):
        """Stratified + jittered query times over the scene's actual time
        span for one union-over-time occupancy refresh. The scene is
        dynamic; refreshing at a single fixed time starved moving-object
        cells of density confirmations and the 0.8/update decay culled
        them (times[0]-only refresh was a silent-quality bug)."""
        S = max(int(self.cfg.occ_time_samples), 1)
        times = np.asarray(self.data["times"])
        t_lo, t_hi = float(times.min()), float(times.max())
        strata = jnp.arange(S, dtype=jnp.float32) / S
        u = jax.random.uniform(key, (S,)) / S
        return t_lo + (t_hi - t_lo) * (strata + u)

    def _maybe_update_occ(self):
        """Refresh the occupancy grids if the step counter crossed the
        update interval since the last refresh (one dispatch per grid)."""
        cfg = self.cfg
        if self.occ_spec is None or cfg.occ_update_interval <= 0:
            return
        tick = self.global_step // cfg.occ_update_interval
        if tick == self._last_occ_update:
            return
        self._last_occ_update = tick
        self._occ_refresh_count += 1
        key = jax.random.PRNGKey(0xACC + self.global_step)
        k_l, k_c, k_t = jax.random.split(key, 3)
        ts = self._occ_refresh_times(k_t)
        if "occ_grid_lidar" in self.state:
            self.state["occ_grid_lidar"] = self._occ_update(
                self.state["params"], self.state["occ_grid_lidar"], k_l, ts,
                True)
        if "occ_grid_rgb" in self.state:
            self.state["occ_grid_rgb"] = self._occ_update(
                self.state["params"], self.state["occ_grid_rgb"], k_c, ts,
                False)

    def train(self, max_epochs: Optional[int] = None, log_fn=print):
        cfg = self.cfg
        max_epochs = max_epochs or cfg.epochs
        t0 = _time.time()
        stats = EpochStats(loss=float("nan"), parts={})  # already-done guard
        for ep in range(self.epoch + 1, max_epochs + 1):
            self.epoch = ep
            stats = self.train_one_epoch()
            if ep % max(cfg.eval_interval, 1) == 0 or ep == max_epochs:
                self.save_checkpoint(full=True)
                log_fn(f"[epoch {ep}] loss={stats.loss:.5f} "
                       f"({_time.time() - t0:.1f}s) parts="
                       + " ".join(f"{k}={v:.4f}"
                                  for k, v in stats.parts.items()
                                  if k != "loss"))
        return stats

    # ------------------------------------------------------------------
    # generic novel-view renders (arbitrary pose / resolution / intrinsics):
    # the eval path and the novel-sensor synthesis path
    # (``base_dataset.py:170-227`` overrides flow through here)
    # ------------------------------------------------------------------
    @property
    def has_unet(self):
        return self.unet_trained

    def _get_pano_renderer(self, H, W, K_l, K_hoz):
        key = ("pano", H, W, K_l, K_hoz, bool(self.cfg.render_skip_warp))
        if key not in self._render_cache:
            def fn(params, pose, t, occ_grid=None):
                inds = jnp.arange(H * W, dtype=jnp.int32)
                ro, rd = raylib.get_lidar_rays(pose, inds, H, W, K_l, K_hoz)
                out = self.rend.render(params, ro, rd, t,
                                       cal_lidar_color=True, staged=True,
                                       **self._occ_kwargs(occ_grid,
                                                          lidar=True))
                return {"depth": out["depth_lidar"].reshape(H, W),
                        "raydrop": out["image_lidar"][:, 0].reshape(H, W),
                        "intensity": out["image_lidar"][:, 1].reshape(H, W)}
            self._render_cache[key] = jax.jit(fn)
        return self._render_cache[key]

    def _get_view_renderer(self, H, W):
        key = ("view", H, W, bool(self.cfg.render_skip_warp))
        if key not in self._render_cache:
            def fn(params, pose, K, t, occ_grid=None):
                inds = jnp.arange(H * W, dtype=jnp.int32)
                ro, rd = raylib.get_camera_rays(pose, inds, H, W, K)
                out = self.rend.render(params, ro, rd, t,
                                       cal_lidar_color=False, staged=True,
                                       bg_color=1.0,
                                       **self._occ_kwargs(occ_grid))
                return {"rgb": out["image"].reshape(H, W, 3),
                        "depth": out["depth"].reshape(H, W)}
            self._render_cache[key] = jax.jit(fn)
        return self._render_cache[key]

    def render_pano(self, pose, t, H, W, intrinsics_lidar,
                    intrinsics_hoz_lidar, use_ema=False):
        params = self.state["ema_params"] if use_ema else self.state["params"]
        fn = self._get_pano_renderer(int(H), int(W),
                                     tuple(intrinsics_lidar),
                                     tuple(intrinsics_hoz_lidar))
        out = fn(params, jnp.asarray(pose), jnp.asarray(t, jnp.float32),
                 self.state.get("occ_grid_lidar"))
        return jax.tree.map(np.asarray, out)

    def render_view(self, pose, t, H, W, intrinsics, use_ema=False):
        params = self.state["ema_params"] if use_ema else self.state["params"]
        fn = self._get_view_renderer(int(H), int(W))
        out = fn(params, jnp.asarray(pose),
                 jnp.asarray(intrinsics, jnp.float32),
                 jnp.asarray(t, jnp.float32),
                 self.state.get("occ_grid_rgb"))
        return jax.tree.map(np.asarray, out)

    # ------------------------------------------------------------------
    # refine stage (``trainer.py:905-1017``)
    # ------------------------------------------------------------------
    def refine(self, steps: int = 1000, lr: float = 1e-3, log_fn=print):
        """Render all training frames with the (EMA) field, then train the
        U-Net raydrop refiner on them."""
        from nvsf_tpu.render.sweep import render_lidar_sweep
        from nvsf_tpu.train.refine import refine_raydrop
        scene = self.scene
        # all training frames rendered through the batched mesh-sharded
        # sweep, in groups of frames per dispatch (device-program length
        # stays bounded; ``trainer.py:913-947`` renders one frame at a time)
        inputs, gts = [], []
        group = 4
        for f0 in range(0, len(scene), group):
            fs = list(range(f0, min(f0 + group, len(scene))))
            sw = render_lidar_sweep(
                self.rend, self.state["ema_params"],
                np.asarray(scene.poses_lidar)[fs],
                np.asarray(scene.times)[fs],
                scene.H_lidar, scene.W_lidar, scene.intrinsics_lidar,
                scene.intrinsics_hoz_lidar, mesh=self.mesh,
                occ_kwargs=self._occ_kwargs(
                    self.state.get("occ_grid_lidar"), lidar=True))
            for j, fi in enumerate(fs):
                inputs.append(np.stack([sw["raydrop"][j], sw["intensity"][j],
                                        sw["depth"][j]], axis=0))
                gts.append(scene.images_lidar[fi][:, :, 0][None])
        x = np.stack(inputs)                    # [F, 3, H, W]
        y = np.stack(gts)                       # [F, 1, H, W]
        up, us, losses = refine_raydrop(
            self.unet_spec, self.state["unet_params"],
            self.state["unet_stats"], x, y, steps=steps, lr=lr,
            log_fn=log_fn)
        self.state["unet_params"] = up
        self.state["unet_stats"] = us
        self.unet_trained = True
        self.save_checkpoint(full=False, suffix="refine")
        return losses

    def refine_raydrop_pano(self, pred_raydrop, pred_intensity, pred_depth):
        from nvsf_tpu.train.refine import apply_refinement
        out = apply_refinement(self.unet_spec, self.state["unet_params"],
                               self.state["unet_stats"], pred_raydrop,
                               pred_intensity, pred_depth)
        return np.asarray(out)

    # ------------------------------------------------------------------
    def render_lidar_frame(self, fi, use_ema=False):
        params = self.state["ema_params"] if use_ema else self.state["params"]
        return jax.tree.map(np.asarray, self._eval_lidar(
            params, jnp.int32(fi), self.state.get("occ_grid_lidar")))

    def render_camera_frame(self, fi, use_ema=False):
        params = self.state["ema_params"] if use_ema else self.state["params"]
        return jax.tree.map(np.asarray, self._eval_camera(
            params, jnp.int32(fi), self.state.get("occ_grid_rgb")))

    # ------------------------------------------------------------------
    def save_checkpoint(self, full=True, best=False, suffix=""):
        return ckpt.save_checkpoint(
            self.workspace, self.name, self.epoch, self.global_step,
            self.state, self.stats, full=full, best=best, suffix=suffix,
            unet_trained=self.unet_trained)

    def load_checkpoint(self, which="latest",
                        prefer_refine: Optional[bool] = None) -> bool:
        """Restore the FULL production state: params, EMA, optimizer,
        error maps, U-Net (+ its trained flag), and the occupancy grids —
        so a fresh-process eval/test renders exactly what the training
        process would (``nvsf/nerf/utils.py:682-747``).

        ``prefer_refine`` defaults to False (training resume needs the
        optimizer state the refine checkpoint lacks); test/eval callers
        pass ``cfg.use_refine``."""
        path = ckpt.resolve_checkpoint(self.workspace, self.name, which,
                                       prefer_refine=bool(prefer_refine))
        if path is None:
            return False
        payload = ckpt.load_checkpoint(path)
        self.state["params"] = jax.tree.map(jnp.asarray, payload["model"])
        if payload.get("ema") is not None:
            self.state["ema_params"] = jax.tree.map(jnp.asarray,
                                                    payload["ema"])
        for k_src, k_dst in (("opt_state", "opt_state"),
                             ("error_map", "error_map"),
                             ("error_map_rgb", "error_map_rgb"),
                             ("unet", "unet_params"),
                             ("unet_stats", "unet_stats"),
                             ("occ_grid_lidar", "occ_grid_lidar"),
                             ("occ_grid_rgb", "occ_grid_rgb")):
            if payload.get(k_src) is not None and k_dst in self.state:
                self.state[k_dst] = jax.tree.map(jnp.asarray,
                                                 payload[k_src])
        self.unet_trained = bool(payload.get("unet_trained", False))
        self.epoch = payload.get("epoch", 0)
        self.global_step = payload.get("global_step", 0)
        self.state["step"] = jnp.asarray(self.global_step, jnp.int32)
        self.stats = payload.get("stats", self.stats)
        return True
