"""The composed NVSF neural field: separate LiDAR / camera encoder branches,
shared flow net + sigma net, LiDAR intensity & ray-drop heads, camera color
head (rebuilds ``nvsf/nerf/models/network_dynamic.py``).

Design notes:
  - The reference branches on the host int ``frame_idx`` for the ±1-frame
    temporal warp (``network_dynamic.py:242-271``); here both warp queries
    are always computed and blended with traced boundary masks so the whole
    density function jits once with static shapes.
  - ``torch.no_grad()`` on the warped *hash* queries (grad flows to the flow
    net only through the K-planes) maps to ``jax.lax.stop_gradient``.
  - Masked color inference (``network_dynamic.py:290-332``) is dense compute
    + mask multiply instead of gather/scatter compaction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from nvsf_tpu.models.encodings import (FREQ_DEG12_DIM, SH_DEG4_DIM,
                                       frequency_encode, sh_encode_deg4)
from nvsf_tpu.models.flow import FlowFieldSpec
from nvsf_tpu.models.hash_grid import HashGrid4DSpec
from nvsf_tpu.models.mlp import MLPSpec
from nvsf_tpu.models.planes import Planes4DSpec


@jax.custom_vjp
def trunc_exp(x):
    """exp with gradient computed at clamp(x, -15, 15)
    (``nvsf/nerf/activation.py:6-20``)."""
    return jnp.exp(x)


def _trunc_exp_fwd(x):
    return jnp.exp(x), x


def _trunc_exp_bwd(x, g):
    return (g * jnp.exp(jnp.clip(x, -15.0, 15.0)),)


trunc_exp.defvjp(_trunc_exp_fwd, _trunc_exp_bwd)


@dataclass(frozen=True)
class NVSFFieldSpec:
    # K-planes
    min_resolution: int = 32
    n_levels_plane: int = 4
    n_features_per_level_plane: int = 8
    # hash grids
    base_resolution: int = 512
    max_resolution: int = 32768
    time_resolution: int = 8
    n_levels_hash: int = 8
    n_features_per_level_hash: int = 4
    log2_hashmap_size: int = 19
    # per-plane (xyt, xzt, yzt) dynamic hash sizes (``hash_field.py:101``)
    hash_size_dynamic: Tuple[int, int, int] = (15, 13, 13)
    # MLPs
    num_layers_flow: int = 3
    hidden_dim_flow: int = 64
    flow_n_levels: int = 16
    flow_n_features_per_level: int = 8
    flow_base_resolution: int = 32
    flow_max_resolution: int = 8192
    flow_log2_hashmap_size: int = 18
    encoder_remat: bool = True   # remat gather bodies (off: faster, more HBM)
    num_layers_sigma: int = 2
    hidden_dim_sigma: int = 64
    geo_feat_dim: int = 15
    num_layers_lidar: int = 3
    hidden_dim_lidar: int = 64
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    out_color_dim: int = 3
    out_lidar_color_dim: int = 2
    # scene
    num_frames: int = 51
    bound: float = 1.0

    # ------------------------------------------------------------------
    @property
    def planes_spec(self) -> Planes4DSpec:
        return Planes4DSpec(
            output_dim=self.n_features_per_level_plane,
            resolution=(self.min_resolution,) * 3 + (self.time_resolution,),
            multiscale_res=tuple(2 ** n for n in range(self.n_levels_plane)))

    @property
    def hash_spec(self) -> HashGrid4DSpec:
        return HashGrid4DSpec(
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
            time_resolution=self.time_resolution,
            n_levels=self.n_levels_hash,
            n_features_per_level=self.n_features_per_level_hash,
            log2_hashmap_size=self.log2_hashmap_size,
            hash_size_dynamic=tuple(self.hash_size_dynamic),
            remat_gather=self.encoder_remat)

    @property
    def flow_spec(self) -> FlowFieldSpec:
        return FlowFieldSpec(num_layers=self.num_layers_flow,
                             hidden_dim=self.hidden_dim_flow,
                             n_levels=self.flow_n_levels,
                             n_features_per_level=self.flow_n_features_per_level,
                             base_resolution=self.flow_base_resolution,
                             max_resolution=self.flow_max_resolution,
                             log2_hashmap_size=self.flow_log2_hashmap_size,
                             remat_gather=self.encoder_remat)

    @property
    def feature_dim(self) -> int:
        return (self.planes_spec.n_output_dims
                + self.hash_spec.n_output_dims_static
                + self.hash_spec.n_output_dims_dynamic)  # 64 + 32 + 24 = 120

    @property
    def sigma_spec(self) -> MLPSpec:
        return MLPSpec(in_dim=self.feature_dim,
                       hidden_dim=self.hidden_dim_sigma,
                       out_dim=1 + self.geo_feat_dim,
                       n_layers=self.num_layers_sigma)

    @property
    def intensity_spec(self) -> MLPSpec:
        return MLPSpec(in_dim=FREQ_DEG12_DIM + self.geo_feat_dim,
                       hidden_dim=self.hidden_dim_lidar, out_dim=1,
                       n_layers=self.num_layers_lidar)

    raydrop_spec = intensity_spec

    @property
    def color_spec(self) -> MLPSpec:
        return MLPSpec(in_dim=SH_DEG4_DIM + self.geo_feat_dim,
                       hidden_dim=self.hidden_dim_color,
                       out_dim=self.out_color_dim,
                       n_layers=self.num_layers_color)

    # ------------------------------------------------------------------
    def init(self, key):
        ks = jax.random.split(key, 9)
        return {
            "planes_lidar": self.planes_spec.init(ks[0]),
            "hash_lidar": self.hash_spec.init(ks[1]),
            "planes_camera": self.planes_spec.init(ks[2]),
            "hash_camera": self.hash_spec.init(ks[3]),
            "flow": self.flow_spec.init(ks[4]),
            "sigma_net": self.sigma_spec.init(ks[5]),
            "intensity_net": self.intensity_spec.init(ks[6]),
            "raydrop_net": self.raydrop_spec.init(ks[7]),
            "color_net": self.color_spec.init(ks[8]),
        }

    def lr_labels(self, params) -> dict:
        """Per-module LR groups: flow / intensity / raydrop train at 0.1x lr
        (``network_dynamic.py:335-357``)."""
        slow = {"flow", "intensity_net", "raydrop_net"}
        return {
            k: jax.tree.map(lambda _: "slow" if k in slow else "base", v)
            for k, v in params.items()
        }

    # ------------------------------------------------------------------
    def flow(self, params, x, t):
        """x: [N, 3] in [-bound, bound]; t scalar in [0, 1] -> dict of
        forward/backward flow (``network_dynamic.py:197-211``)."""
        xn = (x + self.bound) / (2 * self.bound)
        tcol = jnp.full((xn.shape[0], 1), jnp.asarray(t, jnp.float32))
        xt = jnp.concatenate([xn, tcol], axis=-1)
        f = self.flow_spec.apply(params["flow"], xt)
        return {"flow_forward": f[:, :3], "flow_backward": f[:, 3:]}

    def density(self, params, x, t, cal_lidar_color=False,
                compute_dtype=jnp.float32, skip_warp=False):
        """x: [N, 3] in [-bound, bound]; t scalar in [0, 1].

        Returns {"sigma": [N], "geo_feat": [N, geo_feat_dim]}
        (``network_dynamic.py:213-287``).

        ``skip_warp=True`` drops the flow evaluation and the ±1-frame
        temporal feature blend — a ~3x cheaper query used by the
        occupancy-grid refresh, where sigma is only thresholded against a
        decayed max (the render path always uses the full blend).
        """
        branch = "lidar" if cal_lidar_color else "camera"
        hash_p = params[f"hash_{branch}"]
        plane_p = params[f"planes_{branch}"]
        hspec, pspec = self.hash_spec, self.planes_spec

        xn = (x + self.bound) / (2 * self.bound)
        t = jnp.asarray(t, jnp.float32).reshape(())
        frame_idx = jnp.floor(t * (self.num_frames - 1))

        hash_s = hspec.apply_static(hash_p, xn)
        tcol = jnp.full((xn.shape[0], 1), t)
        xt = jnp.concatenate([xn, tcol], axis=-1)

        if skip_warp:
            hash_d = hspec.apply_dynamic(hash_p, xn, t)
            plane_s = pspec.apply_static(plane_p, xt)
            plane_d = pspec.apply_dynamic(plane_p, xt)
            h = self.sigma_spec.apply_blocks(
                params["sigma_net"], [plane_s, plane_d, hash_s, hash_d],
                compute_dtype).astype(jnp.float32)
            return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}

        flow = self.flow_spec.apply(params["flow"], xt, compute_dtype)

        # ±1-frame temporal warp; note the reference normalizes the warped
        # times by num_frames (not num_frames - 1) — kept as-is.
        # All three temporal queries (t, t±1) are batched with vmap over
        # (position set, time) pairs: one encoder graph instead of three
        # unrolled copies (compile time) and one big fused gather batch
        # (run time). The warped slices are stop_gradient'ed, replicating
        # the reference's no_grad on the hash re-queries
        # (``network_dynamic.py:245-271``) — table grads flow only through
        # the t-slice, and grads reach the flow net only via the K-planes.
        t1 = (frame_idx + 1) / self.num_frames
        t2 = (frame_idx - 1) / self.num_frames
        x1 = xn + flow[:, :3]
        x2 = xn + flow[:, 3:]
        has_next = frame_idx < self.num_frames - 1
        has_prev = frame_idx > 0

        # all three temporal queries share ONE fused gather; only the
        # t-query carries table gradients — the warp queries replicate the
        # reference's no_grad hash re-queries (``network_dynamic.py:245-271``)
        hash_d, hash_1, hash_2 = hspec.apply_dynamic_fused3(
            hash_p, xn, x1, x2, t, t1, t2)

        ts3 = jnp.stack([t, t1, t2])
        tcols = ts3[:, None, None] * jnp.ones((3, xn.shape[0], 1))
        xs = jnp.stack([xn, x1, x2])                   # [3, N, 3]
        xts = jnp.concatenate([xs, tcols], axis=-1)    # [3, N, 4]
        plane_s = pspec.apply_static(plane_p, xt)
        # all three plane queries need grads (the flow net learns through
        # the warped K-planes, ``network_dynamic.py:245-271``); they share
        # one fused gather + one backward segment-sum
        plane_d3 = pspec.apply_dynamic_multi(plane_p, xts)
        plane_d, plane_1, plane_2 = plane_d3[0], plane_d3[1], plane_d3[2]

        hash_1 = jnp.where(has_next, hash_1, hash_d)
        plane_1 = jnp.where(has_next, plane_1, plane_d)
        hash_2 = jnp.where(has_prev, hash_2, hash_d)
        plane_2 = jnp.where(has_prev, plane_2, plane_d)

        plane_d = 0.5 * plane_d + 0.25 * (plane_1 + plane_2)
        hash_d = 0.5 * hash_d + 0.25 * (hash_1 + hash_2)

        # NO feature concat: the sigma net's first layer is split per
        # block instead (apply_blocks)
        h = self.sigma_spec.apply_blocks(
            params["sigma_net"], [plane_s, plane_d, hash_s, hash_d],
            compute_dtype).astype(jnp.float32)
        sigma = trunc_exp(h[..., 0])
        return {"sigma": sigma, "geo_feat": h[..., 1:]}

    def density_joint(self, params, x_l, x_c, t, compute_dtype=jnp.float32,
                      x_flow_extra=None):
        """Density for BOTH branches (LiDAR sample points ``x_l`` and camera
        sample points ``x_c``, world coords in [-bound, bound], shared
        scalar t) with CROSS-BRANCH FUSED encoder gathers.

        The reference evaluates the two branches in separate render calls
        (``network_dynamic.py:213-287`` invoked per modality from
        ``trainer.py:193-200,491-499``); this joint path fuses per family:
          - one static-hash gather over both branches' tables,
          - one dynamic-hash gather over 2 branches x 3 temporal queries,
          - one K-planes multi-corner sampler call for statics and one for
            all 6 dynamic queries,
          - one flow evaluation over the concatenated points (the flow net
            is SHARED between branches, ``network_dynamic.py:117-122``),
          - one shared sigma-net matmul batch.

        ``x_flow_extra``: optional [E, 3] extra world points whose flow is
        needed by the flow-consistency loss (``trainer.py:237-273``) — they
        ride in the same flow gather/MLP batch for free.

        Returns {"sigma_l", "geo_feat_l", "sigma_c", "geo_feat_c"[,
        "flow_extra"]}.
        """
        hspec, pspec = self.hash_spec, self.planes_spec
        p_hash = [params["hash_lidar"], params["hash_camera"]]
        p_plane = [params["planes_lidar"], params["planes_camera"]]

        N_l = x_l.shape[0]
        N_c = x_c.shape[0]
        xn_l = (x_l + self.bound) / (2 * self.bound)
        xn_c = (x_c + self.bound) / (2 * self.bound)
        t = jnp.asarray(t, jnp.float32).reshape(())
        frame_idx = jnp.floor(t * (self.num_frames - 1))

        hash_s_l, hash_s_c = hspec.apply_static_joint(p_hash, [xn_l, xn_c])

        # one flow batch: both branches + any loss-side extra points
        xn_all = jnp.concatenate([xn_l, xn_c], axis=0)
        if x_flow_extra is not None:
            xe = (x_flow_extra + self.bound) / (2 * self.bound)
            xn_all = jnp.concatenate([xn_all, xe], axis=0)
        tcol = jnp.full((xn_all.shape[0], 1), t)
        xt_all = jnp.concatenate([xn_all, tcol], axis=-1)
        flow_all = self.flow_spec.apply(params["flow"], xt_all,
                                        compute_dtype)
        flow_l = flow_all[:N_l]
        flow_c = flow_all[N_l:N_l + N_c]
        flow_extra = flow_all[N_l + N_c:] if x_flow_extra is not None \
            else None

        t1 = (frame_idx + 1) / self.num_frames
        t2 = (frame_idx - 1) / self.num_frames
        has_next = frame_idx < self.num_frames - 1
        has_prev = frame_idx > 0
        x1_l = xn_l + flow_l[:, :3]
        x2_l = xn_l + flow_l[:, 3:]
        x1_c = xn_c + flow_c[:, :3]
        x2_c = xn_c + flow_c[:, 3:]

        (hd_l, h1_l, h2_l), (hd_c, h1_c, h2_c) = \
            hspec.apply_dynamic_fused3_joint(
                p_hash, [(xn_l, x1_l, x2_l), (xn_c, x1_c, x2_c)], t, t1, t2)

        xt_l = xt_all[:N_l]
        xt_c = xt_all[N_l:N_l + N_c]
        plane_s_l, plane_s_c = pspec.apply_static_joint(p_plane,
                                                        [xt_l, xt_c])

        def stack3(xn, x1, x2, N):
            ts3 = jnp.stack([t, t1, t2])
            tcols = ts3[:, None, None] * jnp.ones((3, N, 1))
            xs = jnp.stack([xn, x1, x2])
            return jnp.concatenate([xs, tcols], axis=-1)   # [3, N, 4]

        pd3_l, pd3_c = pspec.apply_dynamic_multi_branches(
            p_plane, [stack3(xn_l, x1_l, x2_l, N_l),
                      stack3(xn_c, x1_c, x2_c, N_c)])

        def blend(pd3, hd, h1, h2):
            p_d, p_1, p_2 = pd3[0], pd3[1], pd3[2]
            h1 = jnp.where(has_next, h1, hd)
            p_1 = jnp.where(has_next, p_1, p_d)
            h2 = jnp.where(has_prev, h2, hd)
            p_2 = jnp.where(has_prev, p_2, p_d)
            return (0.5 * p_d + 0.25 * (p_1 + p_2),
                    0.5 * hd + 0.25 * (h1 + h2))

        plane_d_l, hash_d_l = blend(pd3_l, hd_l, h1_l, h2_l)
        plane_d_c, hash_d_c = blend(pd3_c, hd_c, h1_c, h2_c)

        # shared sigma net over BOTH branches' samples in one matmul batch
        # (batch-axis concat is cheap; lane-axis concat is what apply_blocks
        # avoids)
        blocks = [jnp.concatenate([plane_s_l, plane_s_c], axis=0),
                  jnp.concatenate([plane_d_l, plane_d_c], axis=0),
                  jnp.concatenate([hash_s_l, hash_s_c], axis=0),
                  jnp.concatenate([hash_d_l, hash_d_c], axis=0)]
        h = self.sigma_spec.apply_blocks(params["sigma_net"], blocks,
                                         compute_dtype).astype(jnp.float32)
        sigma = trunc_exp(h[..., 0])
        out = {"sigma_l": sigma[:N_l], "geo_feat_l": h[:N_l, 1:],
               "sigma_c": sigma[N_l:], "geo_feat_c": h[N_l:, 1:]}
        if flow_extra is not None:
            out["flow_extra"] = {"flow_forward": flow_extra[:, :3],
                                 "flow_backward": flow_extra[:, 3:]}
        return out

    def color(self, params, x, d, geo_feat, cal_lidar_color=False, mask=None,
              compute_dtype=jnp.float32):
        """Attribute heads (``network_dynamic.py:290-332``).

        d: [N, 3] view dirs in [-1, 1]; geo_feat: [N, G].
        LiDAR -> [N, 2] (raydrop, intensity); camera -> [N, 3] rgb.
        """
        dn = (d + 1.0) / 2.0
        if cal_lidar_color:
            enc = frequency_encode(dn, degree=12)
            blocks = [enc.astype(jnp.float32), geo_feat.astype(jnp.float32)]
            raydrop = self.raydrop_spec.apply_blocks(
                params["raydrop_net"], blocks, compute_dtype)
            intensity = self.intensity_spec.apply_blocks(
                params["intensity_net"], blocks, compute_dtype)
            h = jnp.concatenate([raydrop, intensity], axis=-1)
        else:
            enc = sh_encode_deg4(dn)
            blocks = [enc.astype(jnp.float32), geo_feat.astype(jnp.float32)]
            h = self.color_spec.apply_blocks(params["color_net"], blocks,
                                             compute_dtype)
        h = jax.nn.sigmoid(h.astype(jnp.float32))
        if mask is not None:
            h = jnp.where(mask[:, None], h, 0.0)
        return h
