"""Volume renderer: uniform z-sampling + alpha compositing, fully jittable.

Rebuilds ``nvsf/nerf/models/renderer_dynamic.py`` as static-shape XLA code:
  - ``near_far_from_aabb`` (the only live piece of the reference's CUDA
    raymarching extension, ``raymarching.cu:105-181``) is a vectorized slab
    test in jnp.
  - ``run()`` (``renderer_dynamic.py:109-265``): uniform ``num_steps``
    z-sampling with stratified perturb, single batched density query over
    N*T points, transmittance compositing via cumprod, the 2x active-sensor
    alpha exponent for LiDAR, masked color query (w > 1e-4), camera
    background blending.
  - ``render(staged=True)`` (``renderer_dynamic.py:267-326``): fixed-size ray
    chunking via ``lax.map`` so full-frame eval compiles once.
  - ``sample_pdf`` hierarchical CDF importance sampling (implemented and
    wired to ``upsample_steps`` — present-but-dead in the reference,
    ``renderer_dynamic.py:8-52``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from nvsf_tpu.models.field import NVSFFieldSpec


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.05):
    """Per-ray slab test vs an axis-aligned box (``raymarching.cu:105-181``).

    aabb: [6] = (xmin, ymin, zmin, xmax, ymax, zmax).
    Returns (nears [N], fars [N]); rays that miss get near=far (zero span).
    """
    eps = 1e-15
    inv_d = 1.0 / jnp.where(jnp.abs(rays_d) < eps,
                            jnp.where(rays_d >= 0, eps, -eps), rays_d)
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = jnp.minimum(t0, t1).max(axis=-1)
    tmax = jnp.maximum(t0, t1).min(axis=-1)
    nears = jnp.maximum(tmin, min_near)
    fars = jnp.maximum(tmax, nears)
    return nears, fars


def stratified_segment_jitter(key, z_sel, sample_dist, T, K):
    """Spread compacted samples over their LOCAL segments (unbiased
    stratified quadrature for occupancy-compacted rendering).

    ``compact_samples`` picks K evenly-strided occupied candidates; with an
    uncarved grid and constant per-ray near/far (the LiDAR branch) every
    step then supervises the SAME ~K radii — the pre-compaction +-0.5 *
    sample_dist jitter covers only K/T of each inter-sample gap, leaving
    the field between the comb shells unsupervised (the round-4
    production-scale fog-collapse mechanism). The reference's CUDA marcher
    never has this failure mode: it steps CONTINUOUSLY with per-step
    perturbation through occupied space (``raymarching.cu:388-427``).

    Midpoint-bin stratification: each selected z is drawn uniformly from
    [z - w_l, z + w_r] where w_l/w_r reach to the MIDPOINT of the gap to
    its neighbour (sample_dist/2 at the span boundaries), each capped at
    sample_dist * T/K (half the delta clamp — no point stratifying across
    a grid-carved empty gap wider than the fully-occupied stride).
    Adjacent intervals touch at gap midpoints, so order is preserved, and
    at the fully-occupied stride the bin union covers the whole span.

    z_sel: [N, K] ascending compacted depths; sample_dist: [N, 1] dense
    candidate spacing. Returns jittered [N, K], still ascending.
    """
    N = z_sel.shape[0]
    gap_r = jnp.concatenate(
        [z_sel[:, 1:] - z_sel[:, :-1],
         jnp.broadcast_to(sample_dist, (N, 1))], axis=-1)
    gap_l = jnp.concatenate(
        [jnp.broadcast_to(sample_dist, (N, 1)), gap_r[:, :-1]], axis=-1)
    half_cap = sample_dist * (T / K)      # half the delta clamp
    w_l = jnp.minimum(0.5 * gap_l, half_cap)
    w_r = jnp.minimum(0.5 * gap_r, half_cap)
    u = jax.random.uniform(key, z_sel.shape)
    return z_sel - w_l + u * (w_l + w_r)


def sample_pdf(key, bins, weights, n_samples, det=False):
    """Inverse-CDF hierarchical sampling (``renderer_dynamic.py:8-52``).

    bins: [B, T] z values; weights: [B, T-1]; returns [B, n_samples].
    """
    weights = weights + 1e-5
    pdf = weights / jnp.sum(weights, -1, keepdims=True)
    cdf = jnp.cumsum(pdf, -1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], -1)  # [B, T]
    if det:
        u = jnp.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples)
        u = jnp.broadcast_to(u, cdf.shape[:-1] + (n_samples,))
    else:
        u = jax.random.uniform(key, cdf.shape[:-1] + (n_samples,))
    inds = jax.vmap(partial(jnp.searchsorted, side="right"))(cdf, u)
    below = jnp.maximum(inds - 1, 0)
    above = jnp.minimum(inds, cdf.shape[-1] - 1)
    cdf_b = jnp.take_along_axis(cdf, below, axis=-1)
    cdf_a = jnp.take_along_axis(cdf, above, axis=-1)
    bin_b = jnp.take_along_axis(bins, below, axis=-1)
    bin_a = jnp.take_along_axis(bins, above, axis=-1)
    denom = jnp.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


@dataclass(frozen=True)
class RendererSpec:
    """Static rendering configuration (``renderer_dynamic.py:67-97``)."""
    field: NVSFFieldSpec
    bound: float = 1.0
    density_scale: float = 1.0
    min_near: float = 0.01
    min_near_lidar: float = 0.01
    lidar_max_depth: float = 0.81
    active_sensor: bool = False
    num_steps: int = 768
    upsample_steps: int = 0        # >0 enables importance re-sampling
    max_ray_batch: int = 4096
    compute_dtype: str = "float32"
    remat_chunks: int = 1          # >1: chunked + rematerialized density
                                   # queries (bounds residual memory at
                                   # large rays x samples)
    stream_slab: int = 16          # samples per early-exit slab in the
                                   # streaming eval marcher (16 beat 32 at
                                   # every K in the r3 sweep: finer exit
                                   # granularity outweighs loop overhead)
    occ_jitter: bool = True        # post-compaction stratified segment
                                   # jitter (the r4 fog-collapse fix);
                                   # False = the pre-r4 comb sampling,
                                   # kept as a diagnosis/A-B arm
    occ_delta_clamp: float = 0.0   # per-sample delta cap in units of the
                                   # dense candidate spacing sample_dist.
                                   # 0 = legacy 2*(T/K)*sample_dist gap
                                   # clamp (each kept sample inherits its
                                   # whole skipped span). The reference's
                                   # CUDA marcher composites with the
                                   # LOCAL step dt and skipped space adds
                                   # no opacity (raymarching.cu:388-427);
                                   # occ_delta_clamp=1.0 reproduces that
                                   # quadrature — at compaction ratio K/T
                                   # = 1/8 the legacy gap-deltas amplify
                                   # a weak near-sensor fog's occlusion
                                   # 8-16x, which is the r5-bisected
                                   # production fog-collapse mechanism
    shard_hint: object = None      # optional callable applied to flat
                                   # per-sample tensors (leading axis =
                                   # rays*samples) — set by the Trainer on
                                   # mesh runs to re-assert ray sharding at
                                   # the flatten points (parallel.mesh.
                                   # sample_shard_hint); None = identity

    @property
    def aabb(self):
        b = self.bound
        return jnp.asarray([-b, -b, -b, b, b, b], jnp.float32)

    @property
    def _cdtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32

    def _occ_delta_cap(self, sample_dist, T, K):
        """Per-sample delta cap for occupancy-compacted compositing.

        occ_delta_clamp > 0: cap at clamp * sample_dist — the reference's
        local-dt quadrature (skipped space contributes no opacity,
        ``raymarching.cu:388-427``). 0: legacy 2*(T/K) gap clamp (each
        kept sample's sigma acts over its whole skipped span)."""
        c = self.occ_delta_clamp
        return sample_dist * (c if c > 0 else 2.0 * (T / K))

    def _query_density(self, params, pts, time, cal_lidar_color,
                       skip_warp=False):
        """Field density over a flat [M, 3] point batch.

        With remat_chunks > 1 the batch is processed in sequential chunks
        under jax.checkpoint: the backward recomputes encoder internals per
        chunk instead of saving residuals for all M points at once — this is
        what makes 2048 rays x 768 samples trainable in 16 GB HBM (the
        reference's tcnn kernels recompute similarly)."""
        h = self.shard_hint or (lambda a: a)
        fn = lambda p: self.field.density(
            params, h(p), time, cal_lidar_color=cal_lidar_color,
            compute_dtype=self._cdtype, skip_warp=skip_warp)
        C = self.remat_chunks
        if C <= 1:
            out = fn(pts)
            return {"sigma": h(out["sigma"]),
                    "geo_feat": h(out["geo_feat"])}
        M = pts.shape[0]
        pad = (-M) % C
        pts_p = jnp.pad(pts, ((0, pad), (0, 0))).reshape(C, -1, 3)
        out = jax.lax.map(jax.checkpoint(fn), pts_p)
        sigma = out["sigma"].reshape(-1)[:M]
        geo = out["geo_feat"].reshape(M + pad, -1)[:M]
        return {"sigma": h(sigma), "geo_feat": h(geo)}

    # ------------------------------------------------------------------
    def run(self, params, rays_o, rays_d, time, *, cal_lidar_color=False,
            perturb=False, key=None, bg_color=None, skip_warp=False):
        """Render a flat batch of rays (``renderer_dynamic.py:109-265``).

        rays_o, rays_d: [N, 3]; time: scalar in [0, 1].
        Returns the reference's output dict (keys suffixed ``_lidar`` for the
        LiDAR branch).
        """
        N = rays_o.shape[0]
        T = self.num_steps
        aabb = self.aabb

        if cal_lidar_color:
            nears = jnp.full((N, 1), self.min_near_lidar, jnp.float32)
            fars = jnp.full((N, 1), self.lidar_max_depth, jnp.float32)
        else:
            nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                             self.min_near)
            nears, fars = nears[:, None], fars[:, None]

        z = jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)[None, :]
        z_vals = nears + (fars - nears) * z                      # [N, T]
        sample_dist = (fars - nears) / T                          # [N, 1]

        if perturb:
            assert key is not None, "perturb=True requires a PRNG key"
            key, kz = jax.random.split(key)
            z_vals = z_vals + (jax.random.uniform(kz, z_vals.shape) - 0.5) \
                * sample_dist

        if self.upsample_steps > 0:
            z_vals = self._importance_resample(
                params, rays_o, rays_d, time, z_vals, sample_dist,
                cal_lidar_color, key)
            T = z_vals.shape[-1]

        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = jnp.clip(xyzs, aabb[:3], aabb[3:])

        dout = self._query_density(params, xyzs.reshape(-1, 3), time,
                                   cal_lidar_color, skip_warp=skip_warp)
        sigmas = dout["sigma"].reshape(N, T)
        geo_feat = dout["geo_feat"]

        deltas = z_vals[..., 1:] - z_vals[..., :-1]
        deltas = jnp.concatenate(
            [deltas, jnp.broadcast_to(sample_dist, (N, 1))], axis=-1)

        # LiDAR is an active sensor: light traverses the medium twice
        # (``renderer_dynamic.py:185-189``)
        exponent = 2.0 if self.active_sensor else 1.0
        alphas = 1.0 - jnp.exp(-exponent * deltas * self.density_scale * sigmas)
        trans = jnp.cumprod(
            jnp.concatenate([jnp.ones((N, 1)), 1.0 - alphas + 1e-15], -1),
            axis=-1)[:, :-1]
        weights = alphas * trans                                  # [N, T]

        h = self.shard_hint or (lambda a: a)
        dirs = jnp.broadcast_to(rays_d[:, None, :], xyzs.shape)
        mask = (weights > 1e-4).reshape(-1)
        rgbs = self.field.color(params, h(xyzs.reshape(-1, 3)),
                                h(dirs.reshape(-1, 3)), geo_feat,
                                cal_lidar_color=cal_lidar_color,
                                mask=h(mask), compute_dtype=self._cdtype)
        rgbs = h(rgbs)
        out_dim = rgbs.shape[-1]
        rgbs = rgbs.reshape(N, T, out_dim)

        weights_sum = weights.sum(axis=-1)
        depth = jnp.sum(weights * z_vals, axis=-1)
        image = jnp.sum(weights[..., None] * rgbs, axis=-2)

        if not cal_lidar_color:
            if bg_color is None:
                bg_color = 1.0
            image = image + (1.0 - weights_sum)[..., None] * bg_color

        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image,
                    "weights_sum_lidar": weights_sum,
                    "weights": weights, "z_vals": z_vals}
        return {"depth": depth, "image": image, "weights_sum": weights_sum,
                "weights": weights, "z_vals": z_vals}

    # ------------------------------------------------------------------
    def run_occupancy(self, params, rays_o, rays_d, time, occ_spec, occ_grid,
                      *, num_steps_occ: int, cal_lidar_color=False,
                      perturb=False, key=None, bg_color=None,
                      occ_thresh: float = 0.01, skip_warp=False):
        """Occupancy-accelerated rendering: T_coarse uniform candidates are
        compacted to the K nearest occupied samples per ray (static shapes),
        then the field is evaluated only at N x K points.

        Replaces the reference's CUDA occupancy-grid marcher
        (``raymarching.cu:332-576``) with a fixed-size top-k compaction —
        see ``nvsf_tpu/ops/occupancy.py``.
        """
        N = rays_o.shape[0]
        T = self.num_steps
        K = num_steps_occ
        aabb = self.aabb

        if cal_lidar_color:
            nears = jnp.full((N, 1), self.min_near_lidar, jnp.float32)
            fars = jnp.full((N, 1), self.lidar_max_depth, jnp.float32)
        else:
            nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                             self.min_near)
            nears, fars = nears[:, None], fars[:, None]

        z = jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)[None, :]
        z_cand = nears + (fars - nears) * z
        sample_dist = (fars - nears) / T
        if perturb:
            assert key is not None
            key, kz = jax.random.split(key)
            z_cand = z_cand + (jax.random.uniform(kz, z_cand.shape) - 0.5) \
                * sample_dist

        z_vals, valid = occ_spec.compact_samples(
            occ_grid, rays_o, rays_d, z_cand, K, occ_thresh)   # [N, K]
        if perturb and self.occ_jitter:
            key, kj = jax.random.split(key)
            z_vals = stratified_segment_jitter(kj, z_vals, sample_dist,
                                               T, K)

        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = jnp.clip(xyzs, aabb[:3], aabb[3:])
        dout = self._query_density(params, xyzs.reshape(-1, 3), time,
                                   cal_lidar_color, skip_warp=skip_warp)
        sigmas = dout["sigma"].reshape(N, K)
        geo_feat = dout["geo_feat"]

        # deltas between selected samples; masked-out slots contribute
        # nothing (sigma -> 0 via mask)
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
        deltas = jnp.concatenate(
            [deltas, jnp.broadcast_to(sample_dist, (N, 1))], axis=-1)
        # clamp segment length: gaps spanning skipped EMPTY space must not
        # inherit this sample's sigma over the whole gap (and with
        # occ_delta_clamp set, not even skipped OCCUPIED space — the
        # reference's local-dt quadrature)
        deltas = jnp.clip(deltas, 0.0,
                          self._occ_delta_cap(sample_dist, T, K))
        sigmas = jnp.where(valid, sigmas, 0.0)

        exponent = 2.0 if self.active_sensor else 1.0
        alphas = 1.0 - jnp.exp(-exponent * deltas * self.density_scale
                               * sigmas)
        trans = jnp.cumprod(
            jnp.concatenate([jnp.ones((N, 1)), 1.0 - alphas + 1e-15], -1),
            axis=-1)[:, :-1]
        weights = alphas * trans

        h = self.shard_hint or (lambda a: a)
        dirs = jnp.broadcast_to(rays_d[:, None, :], xyzs.shape)
        mask = ((weights > 1e-4) & valid).reshape(-1)
        rgbs = self.field.color(params, h(xyzs.reshape(-1, 3)),
                                h(dirs.reshape(-1, 3)), geo_feat,
                                cal_lidar_color=cal_lidar_color,
                                mask=h(mask), compute_dtype=self._cdtype)
        rgbs = h(rgbs)
        rgbs = rgbs.reshape(N, K, -1)

        weights_sum = weights.sum(axis=-1)
        depth = jnp.sum(weights * z_vals, axis=-1)
        image = jnp.sum(weights[..., None] * rgbs, axis=-2)
        if not cal_lidar_color:
            if bg_color is None:
                bg_color = 1.0
            image = image + (1.0 - weights_sum)[..., None] * bg_color
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image,
                    "weights_sum_lidar": weights_sum,
                    "weights": weights, "z_vals": z_vals}
        return {"depth": depth, "image": image, "weights_sum": weights_sum,
                "weights": weights, "z_vals": z_vals}

    # ------------------------------------------------------------------
    def run_joint(self, params, ro_l, rd_l, ro_c, rd_c, time, *,
                  perturb=False, key=None, bg_color=None, occ_spec=None,
                  occ_grid_l=None, occ_grid_c=None, num_steps_occ=None,
                  occ_thresh: float = 0.01, x_flow_extra=None):
        """Render a LiDAR ray batch AND a camera ray batch in ONE pass with
        cross-branch fused encoder gathers (``NVSFFieldSpec.density_joint``).

        The reference renders the two modalities in separate ``run`` calls
        per train step (``trainer.py:193-200,491-499``); fusing them halves
        the number of (row-rate-bound) encoder gather dispatches and
        doubles the shared sigma-net matmul batch. Quadrature per branch is
        identical to ``run``/``run_occupancy``.

        Known limitations of this (experimental, measured-slower,
        default-off) path: one shared K for both branches (no
        ``num_steps_occ_rgb``), no ``remat_chunks`` chunked density query,
        and no ``upsample_steps`` importance resampling — the Trainer
        refuses configs that would silently diverge from the separate path.

        Returns (lidar_out, camera_out[, extra]) — the two usual output
        dicts; ``extra["flow_extra"]`` carries flow for ``x_flow_extra``
        loss points when given.
        """
        N_l, N_c = ro_l.shape[0], ro_c.shape[0]
        T = self.num_steps
        aabb = self.aabb
        use_occ = occ_spec is not None and occ_grid_l is not None
        K = num_steps_occ if use_occ else T

        nears_l = jnp.full((N_l, 1), self.min_near_lidar, jnp.float32)
        fars_l = jnp.full((N_l, 1), self.lidar_max_depth, jnp.float32)
        nears_c, fars_c = near_far_from_aabb(ro_c, rd_c, aabb, self.min_near)
        nears_c, fars_c = nears_c[:, None], fars_c[:, None]

        z_tmpl = jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)[None, :]
        z_l = nears_l + (fars_l - nears_l) * z_tmpl
        z_c = nears_c + (fars_c - nears_c) * z_tmpl
        sd_l = (fars_l - nears_l) / T
        sd_c = (fars_c - nears_c) / T
        if perturb:
            assert key is not None, "perturb=True requires a PRNG key"
            key, kl, kc = jax.random.split(key, 3)
            z_l = z_l + (jax.random.uniform(kl, z_l.shape) - 0.5) * sd_l
            z_c = z_c + (jax.random.uniform(kc, z_c.shape) - 0.5) * sd_c

        if use_occ:
            z_l, valid_l = occ_spec.compact_samples(occ_grid_l, ro_l, rd_l,
                                                    z_l, K, occ_thresh)
            z_c, valid_c = occ_spec.compact_samples(occ_grid_c, ro_c, rd_c,
                                                    z_c, K, occ_thresh)
            if perturb and self.occ_jitter:
                key, kjl, kjc = jax.random.split(key, 3)
                z_l = stratified_segment_jitter(kjl, z_l, sd_l, T, K)
                z_c = stratified_segment_jitter(kjc, z_c, sd_c, T, K)
        else:
            valid_l = valid_c = None

        xyz_l = ro_l[:, None, :] + rd_l[:, None, :] * z_l[..., None]
        xyz_c = ro_c[:, None, :] + rd_c[:, None, :] * z_c[..., None]
        xyz_l = jnp.clip(xyz_l, aabb[:3], aabb[3:])
        xyz_c = jnp.clip(xyz_c, aabb[:3], aabb[3:])

        dout = self.field.density_joint(
            params, xyz_l.reshape(-1, 3), xyz_c.reshape(-1, 3), time,
            compute_dtype=self._cdtype, x_flow_extra=x_flow_extra)

        exponent = 2.0 if self.active_sensor else 1.0

        def composite(N, z_vals, sample_dist, valid, sigmas, geo_feat,
                      xyzs, rays_d, lidar):
            deltas = z_vals[..., 1:] - z_vals[..., :-1]
            deltas = jnp.concatenate(
                [deltas, jnp.broadcast_to(sample_dist, (N, 1))], axis=-1)
            if valid is not None:
                deltas = jnp.clip(deltas, 0.0,
                                  self._occ_delta_cap(sample_dist, T, K))
                sigmas = jnp.where(valid, sigmas, 0.0)
            alphas = 1.0 - jnp.exp(-exponent * deltas * self.density_scale
                                   * sigmas)
            trans = jnp.cumprod(
                jnp.concatenate([jnp.ones((N, 1)), 1.0 - alphas + 1e-15],
                                -1), axis=-1)[:, :-1]
            weights = alphas * trans
            dirs = jnp.broadcast_to(rays_d[:, None, :], xyzs.shape)
            mask = (weights > 1e-4)
            if valid is not None:
                mask = mask & valid
            rgbs = self.field.color(params, xyzs.reshape(-1, 3),
                                    dirs.reshape(-1, 3), geo_feat,
                                    cal_lidar_color=lidar,
                                    mask=mask.reshape(-1),
                                    compute_dtype=self._cdtype)
            rgbs = rgbs.reshape(N, K, -1)
            weights_sum = weights.sum(axis=-1)
            depth = jnp.sum(weights * z_vals, axis=-1)
            image = jnp.sum(weights[..., None] * rgbs, axis=-2)
            return depth, image, weights_sum, weights

        sig_l = dout["sigma_l"].reshape(N_l, K)
        sig_c = dout["sigma_c"].reshape(N_c, K)
        d_l, img_l, ws_l, w_l = composite(N_l, z_l, sd_l, valid_l, sig_l,
                                          dout["geo_feat_l"], xyz_l, rd_l,
                                          True)
        d_c, img_c, ws_c, w_c = composite(N_c, z_c, sd_c, valid_c, sig_c,
                                          dout["geo_feat_c"], xyz_c, rd_c,
                                          False)
        if bg_color is None:
            bg_color = 1.0
        img_c = img_c + (1.0 - ws_c)[..., None] * bg_color

        out_l = {"depth_lidar": d_l, "image_lidar": img_l,
                 "weights_sum_lidar": ws_l, "weights": w_l, "z_vals": z_l}
        out_c = {"depth": d_c, "image": img_c, "weights_sum": ws_c,
                 "weights": w_c, "z_vals": z_c}
        extra = {}
        if "flow_extra" in dout:
            extra["flow_extra"] = dout["flow_extra"]
        return out_l, out_c, extra

    # ------------------------------------------------------------------
    def run_occupancy_stream(self, params, rays_o, rays_d, time, occ_spec,
                             occ_grid, *, num_steps_occ: int,
                             cal_lidar_color=False, bg_color=None,
                             occ_thresh: float = 0.01, slab: int = 32,
                             trans_eps: float = 1e-4, skip_warp=False):
        """Eval-only occupancy rendering with ALIVE-RAY EARLY TERMINATION.

        The K occupancy-compacted samples are composited in z-ordered slabs
        of ``slab`` samples inside a ``lax.while_loop`` that stops as soon
        as every ray in the batch has transmittance < ``trans_eps`` — the
        static-shape analogue of the reference's streaming ``march_rays`` /
        ``composite_rays`` loop that kills converged rays
        (``raymarching.py:367-510``, ``raymarching.cu:809-1077``). Rays
        that hit a surface early stop paying for the samples behind it;
        LiDAR panoramas terminate most slabs after the first surface.

        Quadrature is identical to ``run_occupancy`` (same deltas / masks),
        so outputs match the training-mode renderer exactly when no slab is
        skipped. Not differentiable (while_loop) — eval/render paths only.
        """
        N = rays_o.shape[0]
        T = self.num_steps
        K = num_steps_occ
        S = min(slab, K)
        aabb = self.aabb

        if cal_lidar_color:
            nears = jnp.full((N, 1), self.min_near_lidar, jnp.float32)
            fars = jnp.full((N, 1), self.lidar_max_depth, jnp.float32)
        else:
            nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                             self.min_near)
            nears, fars = nears[:, None], fars[:, None]
        z = jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)[None, :]
        z_cand = nears + (fars - nears) * z
        sample_dist = (fars - nears) / T

        z_vals, valid = occ_spec.compact_samples(
            occ_grid, rays_o, rays_d, z_cand, K, occ_thresh)     # [N, K]
        depth, image, weights_sum = self._stream_composite(
            params, rays_o, rays_d, time, z_vals, valid, sample_dist,
            cal_lidar_color=cal_lidar_color, slab=S, trans_eps=trans_eps,
            skip_warp=skip_warp)

        if not cal_lidar_color:
            if bg_color is None:
                bg_color = 1.0
            image = image + (1.0 - weights_sum)[..., None] * bg_color
            return {"depth": depth, "image": image,
                    "weights_sum": weights_sum}
        return {"depth_lidar": depth, "image_lidar": image,
                "weights_sum_lidar": weights_sum}

    def _stream_composite(self, params, rays_o, rays_d, time, z_vals, valid,
                          sample_dist, *, cal_lidar_color, slab,
                          trans_eps=1e-4, skip_warp=False):
        """Early-exit slab compositor over PRE-COMPACTED samples.

        The while_loop stops when every ray is dead — transmittance below
        ``trans_eps`` OR no valid (occupied) samples left ahead. The second
        clause is what lets empty/sky rays (m=0 valid samples, whose
        transmittance never decays) exit immediately instead of paying
        every slab (the r2 straggler cost)."""
        N, K = z_vals.shape
        T = self.num_steps
        S = slab
        aabb = self.aabb
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
        deltas = jnp.concatenate(
            [deltas, jnp.broadcast_to(sample_dist, (N, 1))], axis=-1)
        deltas = jnp.clip(deltas, 0.0,
                          self._occ_delta_cap(sample_dist, T, K))
        if K % S:
            # Pad the sample axis up to a slab multiple with dead samples
            # (valid=False -> sigma forced to 0, weight 0). Without this,
            # slab_cond's K // S floor silently DROPPED the last K % S
            # samples — and because compact_samples selects samples
            # STRIDED across the whole occupied span, that truncation
            # removed the far tail of every ray (measured: render-K=24 at
            # slab 16 scored CD 3.18 vs 0.22 for K=16 on the ablation
            # scene).
            padk = S - K % S
            z_vals = jnp.pad(z_vals, ((0, 0), (0, padk)), mode="edge")
            deltas = jnp.pad(deltas, ((0, 0), (0, padk)))
            valid = jnp.pad(valid, ((0, 0), (0, padk)))
            K += padk
        m = valid.sum(axis=-1).astype(jnp.int32)                 # [N]
        exponent = 2.0 if self.active_sensor else 1.0
        out_dim = 2 if cal_lidar_color else 3

        def slab_body(carry):
            i, trans, depth, image, wsum = carry
            zs = jax.lax.dynamic_slice(z_vals, (0, i * S), (N, S))
            ds = jax.lax.dynamic_slice(deltas, (0, i * S), (N, S))
            vs = jax.lax.dynamic_slice(valid, (0, i * S), (N, S))
            xyzs = rays_o[:, None, :] + rays_d[:, None, :] * zs[..., None]
            xyzs = jnp.clip(xyzs, aabb[:3], aabb[3:])
            dout = self.field.density(params, xyzs.reshape(-1, 3), time,
                                      cal_lidar_color=cal_lidar_color,
                                      compute_dtype=self._cdtype,
                                      skip_warp=skip_warp)
            sigmas = jnp.where(vs, dout["sigma"].reshape(N, S), 0.0)
            alphas = 1.0 - jnp.exp(-exponent * ds * self.density_scale
                                   * sigmas)
            # transmittance continues from the carry (previous slabs)
            t_in = jnp.cumprod(
                jnp.concatenate([jnp.ones((N, 1)), 1.0 - alphas + 1e-15],
                                axis=-1), axis=-1)
            weights = alphas * trans[:, None] * t_in[:, :-1]     # [N, S]
            dirs = jnp.broadcast_to(rays_d[:, None, :], xyzs.shape)
            mask = ((weights > 1e-4) & vs).reshape(-1)
            rgbs = self.field.color(params, xyzs.reshape(-1, 3),
                                    dirs.reshape(-1, 3), dout["geo_feat"],
                                    cal_lidar_color=cal_lidar_color,
                                    mask=mask, compute_dtype=self._cdtype)
            rgbs = rgbs.reshape(N, S, out_dim)
            return (i + 1,
                    trans * t_in[:, -1],
                    depth + jnp.sum(weights * zs, axis=-1),
                    image + jnp.sum(weights[..., None] * rgbs, axis=-2),
                    wsum + weights.sum(axis=-1))

        def slab_cond(carry):
            i, trans = carry[0], carry[1]
            alive = (trans > trans_eps) & (m > i * S)
            return (i < K // S) & jnp.any(alive)

        init = (jnp.int32(0), jnp.ones((N,), jnp.float32),
                jnp.zeros((N,), jnp.float32),
                jnp.zeros((N, out_dim), jnp.float32),
                jnp.zeros((N,), jnp.float32))
        _, _, depth, image, weights_sum = jax.lax.while_loop(
            slab_cond, slab_body, init)
        return depth, image, weights_sum

    # ------------------------------------------------------------------
    def _render_staged_occ(self, params, rays_o, rays_d, time, occ_spec,
                           occ_grid, K, occ_thresh, cal_lidar_color,
                           bg_color, slab: int | None = None,
                           compact_chunk: int = 8192, skip_warp=False):
        """Full-frame occupancy render with OCCUPANCY-SORTED chunking.

        The r2 marcher early-exited per 4096-ray chunk on
        ``max(transmittance)``: one straggler ray kept its whole chunk
        paying every slab, and sky rays (no occupied samples, trans ~ 1)
        were permanent stragglers. Here the sample compaction runs ONCE
        for all rays (chunked, grid lookups only — no field queries), rays
        are sorted by their occupied-sample count m, and the early-exit
        marcher gets HOMOGENEOUS chunks: sky chunks exit after zero slabs,
        surface chunks after their shared first surface. Outputs are
        unsorted back at the end. Mirrors the alive-ray compaction loop of
        the reference (``raymarching.cu:809-1077``) at chunk granularity.
        """
        N = rays_o.shape[0]
        T = self.num_steps
        aabb = self.aabb
        S = min(self.stream_slab if slab is None else slab, K)
        if cal_lidar_color:
            nears = jnp.full((N, 1), self.min_near_lidar, jnp.float32)
            fars = jnp.full((N, 1), self.lidar_max_depth, jnp.float32)
        else:
            nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                             self.min_near)
            nears, fars = nears[:, None], fars[:, None]
        sample_dist = (fars - nears) / T                          # [N, 1]

        CC = min(compact_chunk, N)
        ncc = -(-N // CC)
        padc = ncc * CC - N
        ro_p = jnp.pad(rays_o, ((0, padc), (0, 0)))
        rd_p = jnp.pad(rays_d, ((0, padc), (0, 0)), constant_values=1.0)
        nr_p = jnp.pad(nears, ((0, padc), (0, 0)))
        fr_p = jnp.pad(fars, ((0, padc), (0, 0)), constant_values=1.0)
        lin = jnp.linspace(0.0, 1.0, T, dtype=jnp.float32)[None, :]

        def comp_chunk(args):
            o, d, nr, fr = args
            z = nr + (fr - nr) * lin
            return occ_spec.compact_samples(occ_grid, o, d, z, K,
                                            occ_thresh)

        z_sel, valid = jax.lax.map(
            comp_chunk, (ro_p.reshape(ncc, CC, 3), rd_p.reshape(ncc, CC, 3),
                         nr_p.reshape(ncc, CC, 1), fr_p.reshape(ncc, CC, 1)))
        Np = ncc * CC
        z_sel = z_sel.reshape(Np, K)
        valid = valid.reshape(Np, K) \
            & (jnp.arange(Np) < N)[:, None]                      # kill pads
        m = valid.sum(axis=-1)

        # sort rays by occupied count -> homogeneous early-exit chunks
        order = jnp.argsort(m)
        inv = jnp.argsort(order)
        C = min(self.max_ray_batch, Np)
        nch = -(-Np // C)
        pad2 = nch * C - Np
        def sort_pad(a, fill=0.0):
            a = a[order]
            return jnp.pad(a, ((0, pad2),) + ((0, 0),) * (a.ndim - 1),
                           constant_values=fill)
        ro_s = sort_pad(ro_p).reshape(nch, C, 3)
        rd_s = sort_pad(rd_p, 1.0).reshape(nch, C, 3)
        z_s = sort_pad(z_sel).reshape(nch, C, K)
        v_s = sort_pad(valid, False).reshape(nch, C, K)
        sd_s = sort_pad(jnp.pad(sample_dist, ((0, padc), (0, 0)),
                                constant_values=1.0)).reshape(nch, C, 1)

        out_dim = 2 if cal_lidar_color else 3

        def chunk_fn(args):
            o, d, z, v, sd = args
            return self._stream_composite(
                params, o, d, time, z, v, sd,
                cal_lidar_color=cal_lidar_color, slab=S,
                skip_warp=skip_warp)

        depth, image, wsum = jax.lax.map(chunk_fn,
                                         (ro_s, rd_s, z_s, v_s, sd_s))
        depth = depth.reshape(-1)[:Np][inv][:N]
        image = image.reshape(-1, out_dim)[:Np][inv][:N]
        wsum = wsum.reshape(-1)[:Np][inv][:N]
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image}
        if bg_color is None:
            bg_color = 1.0
        image = image + (1.0 - wsum)[..., None] * bg_color
        return {"depth": depth, "image": image}

    # ------------------------------------------------------------------
    def _importance_resample(self, params, rays_o, rays_d, time, z_vals,
                             sample_dist, cal_lidar_color, key):
        """Coarse pass -> CDF resample -> merged sorted z values."""
        N, T = z_vals.shape
        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = jnp.clip(xyzs, self.aabb[:3], self.aabb[3:])
        dout = self.field.density(params, xyzs.reshape(-1, 3), time,
                                  cal_lidar_color=cal_lidar_color,
                                  compute_dtype=self._cdtype)
        sigmas = jax.lax.stop_gradient(dout["sigma"]).reshape(N, T)
        deltas = z_vals[..., 1:] - z_vals[..., :-1]
        deltas = jnp.concatenate(
            [deltas, jnp.broadcast_to(sample_dist, (N, 1))], axis=-1)
        alphas = 1.0 - jnp.exp(-deltas * self.density_scale * sigmas)
        trans = jnp.cumprod(
            jnp.concatenate([jnp.ones((N, 1)), 1.0 - alphas + 1e-15], -1),
            axis=-1)[:, :-1]
        weights = alphas * trans
        kz = key if key is not None else jax.random.PRNGKey(0)
        new_z = sample_pdf(kz, z_vals, weights[:, :-1], self.upsample_steps,
                           det=key is None)
        new_z = jax.lax.stop_gradient(new_z)
        return jnp.sort(jnp.concatenate([z_vals, new_z], axis=-1), axis=-1)

    # ------------------------------------------------------------------
    def render(self, params, rays_o, rays_d, time, *, cal_lidar_color=False,
               staged=False, perturb=False, key=None, bg_color=None,
               occ_spec=None, occ_grid=None, num_steps_occ=None,
               occ_thresh: float = 0.01, skip_warp=False):
        """Flat [N, 3] ray batch -> outputs; staged mode chunks rays through
        ``lax.map`` with padding (``renderer_dynamic.py:286-316``).

        With ``occ_spec``/``occ_grid`` provided, staged rendering goes
        through the occupancy-compacted EARLY-TERMINATING marcher
        (``run_occupancy_stream``) instead of the dense ``num_steps`` run —
        the production eval/render path (north-star render target).

        ``skip_warp=True`` renders with the t-query features only (no flow
        eval, no ±1-frame blend) — ~2.6x fewer gather rows per sample. An
        APPROXIMATION of the trained model (the blend is part of its
        density definition): it lost CD and PSNR on a dynamic scene in the
        tools/ablate_render_k.py arms, so it ships default-off as a
        draft/preview mode."""
        use_occ = occ_spec is not None and occ_grid is not None
        if not staged:
            if use_occ:
                return self.run_occupancy(
                    params, rays_o, rays_d, time, occ_spec, occ_grid,
                    num_steps_occ=num_steps_occ, occ_thresh=occ_thresh,
                    cal_lidar_color=cal_lidar_color, perturb=perturb,
                    key=key, bg_color=bg_color, skip_warp=skip_warp)
            return self.run(params, rays_o, rays_d, time,
                            cal_lidar_color=cal_lidar_color, perturb=perturb,
                            key=key, bg_color=bg_color, skip_warp=skip_warp)

        if use_occ:
            return self._render_staged_occ(
                params, rays_o, rays_d, time, occ_spec, occ_grid,
                num_steps_occ, occ_thresh, cal_lidar_color, bg_color,
                skip_warp=skip_warp)

        N = rays_o.shape[0]
        C = min(self.max_ray_batch, N)
        n_chunks = -(-N // C)
        pad = n_chunks * C - N
        ro = jnp.pad(rays_o, ((0, pad), (0, 0))).reshape(n_chunks, C, 3)
        rd = jnp.pad(rays_d, ((0, pad), (0, 0)), constant_values=1.0) \
            .reshape(n_chunks, C, 3)

        def chunk_fn(args):
            o, d = args
            r = self.run(params, o, d, time,
                         cal_lidar_color=cal_lidar_color, perturb=False,
                         bg_color=bg_color, skip_warp=skip_warp)
            if cal_lidar_color:
                return r["depth_lidar"], r["image_lidar"]
            return r["depth"], r["image"]

        depth, image = jax.lax.map(chunk_fn, (ro, rd))
        depth = depth.reshape(-1)[:N]
        image = image.reshape(-1, image.shape[-1])[:N]
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image}
        return {"depth": depth, "image": image}
