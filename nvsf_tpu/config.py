"""Config system: dataclass + configargparse-compatible txt files + CLI.

Keeps the flag surface of the reference CLI (``nvsf/scripts/main_nvsf.py:11-133``)
so that reference config txt files (e.g. ``nvsf/configs/kitti360_1908.txt``,
generated by ``cal_centerpose_bound.py:136-167``) parse unchanged.

Config txt format (configargparse subset):
  - ``# comment`` lines
  - ``key = value`` pairs
  - bare ``flag`` lines meaning ``flag = True``
  - list values as ``[a, b, c]`` or space separated
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field, fields
from typing import List, Optional, Union


def _flt_list(*vals):
    return lambda: list(vals)


@dataclass
class NVSFConfig:
    """All training / eval / rendering options.

    Field names match the reference CLI flags one-to-one
    (``main_nvsf.py:14-131``); defaults match the reference defaults.
    """

    # --- entry / workspace ---
    config: str = ""                      # config file path
    path: str = ""                        # pano images + transforms json root
    name: str = "nvsf"
    L: bool = False                       # equals --fp16 --preload
    test: bool = False
    test_eval: bool = False
    workspace: str = "log"
    cluster_summary_path: str = "/summary"
    seed: int = 0
    preload: bool = True                  # device-resident frames (always true here)

    # --- dataset ---
    dataloader: str = "kitti360"          # kitti360 | synthetic (dgt/daas absent upstream too)
    sequence_id: str = ""
    min_near: float = 1.0
    min_near_lidar: float = 1.0
    lidar_max_depth: float = 80.0
    intrinsics_lidar: List[float] = field(default_factory=_flt_list(2.0, 26.9))
    intrinsics_hoz_lidar: List[float] = field(default_factory=_flt_list(180.0, 360.0))
    offset: List[float] = field(default_factory=_flt_list(0.0, 0.0, 0.0))
    scale: float = 0.01
    bound: float = 2.0
    num_frames: int = 64
    color_space: str = "srgb"
    active_sensor: bool = False

    # --- network ---
    refine: bool = False
    use_refine: bool = False
    fp16: bool = False                    # selects bf16 compute
    min_resolution: int = 32
    base_resolution: int = 512
    max_resolution: int = 32768
    time_resolution: int = 8
    n_levels_plane: int = 4
    n_features_per_level_plane: int = 8
    n_levels_hash: int = 8
    n_features_per_level_hash: int = 4
    log2_hashmap_size: int = 19
    # per-plane (xyt,xzt,yzt) dynamic hash sizes (ref `hash_field.py:101`)
    hash_size_dynamic: List[int] = field(default_factory=lambda: [15, 13, 13])
    num_layers_flow: int = 3
    hidden_dim_flow: int = 64
    flow_n_levels: int = 16
    flow_n_features_per_level: int = 8
    flow_base_resolution: int = 32
    flow_max_resolution: int = 8192
    flow_log2_hashmap_size: int = 18
    num_layers_sigma: int = 2
    hidden_dim_sigma: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_lidar: int = 64
    out_lidar_dim: int = 2

    # --- training ---
    eval_interval: int = 100
    activate_levels: int = 0
    enable_rgb: bool = False
    enable_lidar: bool = False
    epochs: int = 500
    lr: float = 1e-2
    ckpt: str = "latest"
    num_rays: int = 2048
    num_rays_lidar: int = 2048
    num_steps: int = 768
    upsample_steps: int = 64
    max_ray_batch: int = 4096
    raydrop_thres: float = 0.5
    smooth_factor: float = 0.0
    density_scale: float = 1.0
    ema_decay: float = 0.95
    use_error_map: bool = False
    vis_training: bool = False
    # write a jax.profiler device trace of the first warm epoch here
    # (viewable in TensorBoard/xprof); "" disables. SURVEY §5: the
    # reference has no profiling beyond a wall-clock print.
    profile_dir: str = ""

    # --- losses ---
    rgb_loss: str = "mse"
    rgb_depth_loss: str = "l1"
    depth_loss: str = "l1"
    depth_grad_loss: str = "l1"
    intensity_loss: str = "mse"
    raydrop_loss: str = "mse"
    flow_loss: bool = False
    grad_loss: bool = False
    use_rgbd_loss: bool = False
    use_urf_loss: bool = False
    alpha_d: float = 1.0
    alpha_i: float = 0.1
    alpha_r: float = 0.01
    alpha_rgb: float = 1.0
    alpha_rd: float = 1.0

    # --- structural regularization ---
    alpha_grad_norm: float = 0.1
    alpha_spatial: float = 0.1
    alpha_tv: float = 0.1
    alpha_grad: float = 0.1
    grad_norm_smooth: bool = False
    spatial_smooth: bool = False
    tv_loss: bool = False
    sobel_grad: bool = False
    patch_size: int = 1
    patch_size_lidar: int = 1
    change_patch_size_lidar: List[int] = field(default_factory=lambda: [2, 8])
    change_patch_size_epoch: int = 2
    intensity_inv_scale: float = 1.0
    raydrop_ratio: float = 0.5
    # AlexNet-LPIPS weights npz (tools/export_lpips_weights.py schema);
    # empty -> the NVSF_TPU_LPIPS_WEIGHTS env var -> NaN columns (the
    # pretrained weights cannot be downloaded in a zero-egress env)
    lpips_weights: str = ""

    # --- (torch-ngp heritage flags, kept for config compatibility) ---
    dt_gamma: float = 1.0 / 128
    density_thresh: float = 10.0
    # density-mesh export window; defaults are the reference CLI's values
    # (``nvsf/scripts/main_nvsf.py:297-300``), overridable per scene
    mesh_bound_min: List[float] = field(default_factory=_flt_list(-0.5, -0.5, 0.06))
    mesh_bound_max: List[float] = field(default_factory=_flt_list(0.5, 0.5, 0.09))
    mesh_xyz_res: List[int] = field(default_factory=lambda: [256, 256, 32])
    bg_radius: float = -1.0

    # --- novel-sensor synthesis overrides (base_dataset.py:170-227 semantics) ---
    delta_position: List[float] = field(default_factory=_flt_list(0.0, 0.0, 0.0))
    delta_orientation: List[float] = field(default_factory=_flt_list(0.0, 0.0, 0.0))
    intrinsics_lidar_new: List[float] = field(default_factory=_flt_list(0.0, 0.0))
    intrinsics_hoz_lidar_new: List[float] = field(default_factory=_flt_list(0.0, 0.0))
    V_lidar_ch: int = 0
    H_lidar_ch: int = 0
    H_new: int = 0
    W_new: int = 0
    delta_pos_camera: List[float] = field(default_factory=_flt_list(0.0, 0.0, 0.0))
    delta_orient_camera: List[float] = field(default_factory=_flt_list(0.0, 0.0, 0.0))

    # --- additions (not in reference) ---
    render_mode: str = "uniform"          # uniform | occupancy
    num_steps_occ: int = 256              # max kept samples in occupancy mode
    num_steps_occ_rgb: int = 0            # camera-branch TRAINING kept-sample
                                          # budget (0 = num_steps_occ):
                                          # lets the LiDAR branch train at
                                          # 96-of-768 while RGB keeps the
                                          # full 128
    num_steps_occ_render: int = 0         # render-time kept-sample budget for
                                          # LiDAR eval/novel-view panos
                                          # (0 = num_steps_occ); camera
                                          # renders use their
                                          # training budget num_steps_occ_rgb
                                          # (or num_steps_occ)
    render_skip_warp: bool = False        # eval/test renders query the
                                          # field WITHOUT the flow eval and
                                          # the ±1-frame temporal blend
                                          # (~2.6x fewer gather rows/sample;
                                          # an approximation of the trained
                                          # model; default off)
    occ_grid_size: int = 128              # occupancy grid resolution
    occ_thresh: float = 1.0               # density threshold for occupancy
    occ_update_interval: int = 16         # grid-update cadence (steps)
    max_dispatch_steps: int = 0           # cap steps per scan DISPATCH
                                          # (0 = occ_update_interval);
                                          # bounds one device program's
                                          # length WITHOUT changing the
                                          # occ refresh cadence, which
                                          # stays keyed to global_step
    occ_update_fraction: int = 16         # update G^3/fraction cells/update
    occ_time_samples: int = 4             # stratified query times per refresh
                                          # (union-over-time occupancy for
                                          # dynamic scenes)
    occ_decay: float = 0.8                # per-refresh density decay; gentle
                                          # enough that a moving object's
                                          # cells survive missed time samples
    stream_slab: int = 16                 # samples per early-exit slab in
                                          # the streaming eval marcher
    occ_jitter: bool = True               # post-compaction stratified
                                          # segment jitter in occupancy-mode
                                          # training (r4 fog-collapse fix);
                                          # False reverts to comb sampling
    occ_delta_clamp: float = 0.0          # occupancy-path per-sample delta
                                          # cap in units of the dense
                                          # candidate spacing; 1.0 = the
                                          # reference marcher's local-dt
                                          # quadrature, 0 = legacy
                                          # 2*(T/K) whole-gap deltas (see
                                          # renderer.RendererSpec)
    joint_fusion: bool = False            # fuse LiDAR+camera encoder gathers
                                          # into one joint render per step;
                                          # default off, not measured on
                                          # the GPU yet
    remat_chunks: int = 1                 # chunked+remat density queries
    encoder_remat: bool = True            # remat encoder gather bodies
    refine_steps: int = 1000              # U-Net refine iterations
    mesh_shape: str = ""                  # e.g. "8" or "4x2"; empty => all devices, 1D
    compute_dtype: str = "float32"        # float32 | bfloat16 (hot-path compute)
    iters: int = 0                        # derived: epochs * steps_per_epoch

    # ------------------------------------------------------------------
    def finalize(self, steps_per_epoch: int = 1) -> "NVSFConfig":
        """Apply the derived-value rules from ``main_nvsf.py:158-172``."""
        out = dataclasses.replace(self)
        if out.L:
            out.fp16 = True
            out.preload = True
        if out.patch_size > 1:
            assert out.num_rays % (out.patch_size ** 2) == 0, \
                "patch_size ** 2 should divide num_rays"
        # scale nears/fars into the normalized scene box
        out.min_near = self.min_near * self.scale
        out.min_near_lidar = self.min_near_lidar * self.scale
        out.lidar_max_depth = self.lidar_max_depth * self.scale
        assert out.bg_radius <= 0, "background sphere model is not implemented"
        assert out.enable_lidar or out.enable_rgb, \
            "At least one of LiDAR or camera must be enabled"
        if out.iters == 0:
            out.iters = int(out.epochs * steps_per_epoch)
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for k, v in self.to_dict().items():
                f.write(f"{k} = {v}\n")

    @classmethod
    def from_dict(cls, d: dict) -> "NVSFConfig":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ----------------------------------------------------------------------
# config-txt parsing (configargparse subset)
# ----------------------------------------------------------------------

_FIELD_TYPES = {f.name: f for f in fields(NVSFConfig)}


def _parse_scalar(s: str):
    s = s.strip()
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("[") and raw.endswith("]"):
        inner = raw[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(p) for p in inner.split(",")]
    if "," in raw:
        return [_parse_scalar(p) for p in raw.split(",")]
    parts = raw.split()
    if len(parts) > 1:
        return [_parse_scalar(p) for p in parts]
    return _parse_scalar(raw)


def _coerce(name: str, value):
    """Coerce a parsed value to the dataclass field's declared type."""
    fld = _FIELD_TYPES.get(name)
    if fld is None:
        return value
    ftype = fld.type if isinstance(fld.type, str) else getattr(fld.type, "__name__", "")
    is_list = "List" in str(ftype) or "list" in str(ftype)
    if is_list:
        if not isinstance(value, list):
            value = [value]
        if "float" in str(ftype):
            return [float(v) for v in value]
        if "int" in str(ftype):
            return [int(v) for v in value]
        return value
    if isinstance(fld.default, bool) or str(ftype) == "bool":
        if isinstance(value, bool):
            return value
        return bool(value)
    if isinstance(fld.default, float) or str(ftype) == "float":
        return float(value)
    if isinstance(fld.default, int) and not isinstance(fld.default, bool):
        return int(value)
    return value


def parse_config_file(path: str) -> dict:
    """Parse a configargparse-style txt (or a json) config file."""
    out = {}
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" in line:
            key, raw = line.split("=", 1)
            key = key.strip().lstrip("-")
            out[key] = _coerce(key, _parse_value(raw))
        else:
            key = line.strip().lstrip("-")
            out[key] = True
    return out


def build_arg_parser() -> argparse.ArgumentParser:
    """argparse surface auto-generated from the dataclass; flag names match
    the reference CLI (``main_nvsf.py:11-133``)."""
    p = argparse.ArgumentParser("nvsf_tpu", description=__doc__)
    for f in fields(NVSFConfig):
        name = f"--{f.name}"
        default = argparse.SUPPRESS  # only record explicitly-passed flags
        ftype = str(f.type)
        if "List" in ftype or "list" in ftype:
            elem = float if "float" in ftype else int
            p.add_argument(name, nargs="+", type=elem, default=default)
        elif ftype == "bool" or isinstance(f.default, bool):
            p.add_argument(name, action="store_true", default=default)
        elif ftype == "float" or isinstance(f.default, float):
            p.add_argument(name, type=float, default=default)
        elif ftype == "int" or isinstance(f.default, int):
            p.add_argument(name, type=int, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    # short alias from the reference
    p.add_argument("-L", dest="L", action="store_true", default=argparse.SUPPRESS)
    return p


def load_config(argv: Optional[List[str]] = None) -> NVSFConfig:
    """CLI entry: merge (defaults < config file < CLI flags)."""
    parser = build_arg_parser()
    ns = parser.parse_args(argv)
    cli = vars(ns)
    merged = {}
    cfg_path = cli.get("config", "")
    if cfg_path:
        merged.update(parse_config_file(cfg_path))
    merged.update(cli)
    merged = {k: _coerce(k, v) for k, v in merged.items()}
    return NVSFConfig.from_dict(merged)
