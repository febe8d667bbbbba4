"""K-planes (Planes4D) factorization of the (x, y, z, t) volume in pure JAX.

Rebuilds ``nvsf/nerf/models/planes_field.py``: C(4,2)=6 planes per scale,
4 multiscale levels (spatial resolution x1/2/4/8, time resolution fixed),
bilinear lookups with align_corners=True + border padding, static planes
(xy, xz, yz) and dynamic planes (xt, yt, zt) reduced by product over the
3 planes of each group, features concatenated across scales.

Plane tables are SMALL (<= 256*256 slots): fine scales use per-plane
gathers with autodiff backward, coarse scales and the time-folded dynamic
planes go through the multi-corner sampler of ``ops/multihot.py``. The
temporal-warp queries are batched by concatenating their POINTS — time is
a plane coordinate, so all queries share one table pass.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

# combinations of (x, y, z, t) taken 2 at a time, in itertools order
_COO_COMBS = tuple(itertools.combinations(range(4), 2))
_STATIC = tuple(ci for ci, cc in enumerate(_COO_COMBS) if 3 not in cc)
_DYNAMIC = tuple(ci for ci, cc in enumerate(_COO_COMBS) if 3 in cc)


def _bilinear_sample_fmajor(plane_flat: jnp.ndarray, H: int, W: int,
                            u: jnp.ndarray, v: jnp.ndarray):
    """Sample a plane stored flat as [F, H*W] at continuous coords
    (u in [0,1] -> W axis, v in [0,1] -> H axis) with align_corners=True +
    border clamping — F.grid_sample semantics of ``planes_field.py:55-83``.

    Planes are stored 2D [F, H*W] (not [F, H, W]); returns features-major
    [F, N]."""
    x = jnp.clip(u, 0.0, 1.0) * (W - 1)
    y = jnp.clip(v, 0.0, 1.0) * (H - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    wx = x - x0
    wy = y - y0

    def gather(yy, xx):
        return plane_flat.at[:, yy * W + xx].get(
            mode="promise_in_bounds")  # [F, N]

    out = (gather(y0, x0) * ((1 - wx) * (1 - wy))[None]
           + gather(y0, x1) * (wx * (1 - wy))[None]
           + gather(y1, x0) * ((1 - wx) * wy)[None]
           + gather(y1, x1) * (wx * wy)[None])
    return out


# note: no rematerialization — only the single static-group query uses this
# path now (the dynamic planes go through ops/multihot.py), and its corner
# residuals (~400MB at 262k samples) fit HBM comfortably; the remat re-ran
# all 48 corner gathers in the backward (~60ms/step)
_bilinear_remat = _bilinear_sample_fmajor


def _bilinear_cols_weights(u, v, H, W):
    """Flat bilinear corner columns + weights (align_corners + border clamp,
    matching ``_bilinear_sample_fmajor``): ([4, N] int32, [4, N] f32)."""
    x = jnp.clip(u, 0.0, 1.0) * (W - 1)
    y = jnp.clip(v, 0.0, 1.0) * (H - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    wx = x - x0
    wy = y - y0
    cols = jnp.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    wts = jnp.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                     (1 - wx) * wy, wx * wy])
    return cols, wts


def bilinear_sample(plane, u, v):
    """Public [N, F] variant; accepts [F, H, W] planes."""
    F, H, W = plane.shape
    return _bilinear_sample_fmajor(plane.reshape(F, H * W), H, W, u, v).T


@dataclass(frozen=True)
class Planes4DSpec:
    output_dim: int = 8
    resolution: Tuple[int, int, int, int] = (32, 32, 32, 8)   # (x, y, z, t)
    multiscale_res: Tuple[int, ...] = (1, 2, 4, 8)
    # reduction within a scale's 3-plane group is 'prod' (reference default)

    @property
    def n_output_dims(self) -> int:
        # concat over scales, x2 for (static, dynamic)
        return self.output_dim * len(self.multiscale_res) * 2

    def _scale_resolution(self, s: int):
        r = list(self.resolution)
        return [rr * s for rr in r[:3]] + r[3:]  # time res not scaled

    def plane_hw(self, si: int, ci: int):
        """(H, W) = (res_b, res_a) of plane ci at scale si."""
        reso = self._scale_resolution(self.multiscale_res[si])
        a, b = _COO_COMBS[ci]
        return reso[b], reso[a]

    def init(self, key):
        """Planes stored as [scale][ci] arrays of FLAT shape [F, res_b*res_a]
        for coo_comb (a, b) — time planes init to ones, spatial U(0.1, 0.5)
        (``planes_field.py:31-52``)."""
        params = []
        keys = jax.random.split(key, len(self.multiscale_res) * 6).reshape(
            len(self.multiscale_res), 6, -1)
        for si in range(len(self.multiscale_res)):
            scale_planes = []
            for ci, (a, b) in enumerate(_COO_COMBS):
                H, W = self.plane_hw(si, ci)
                shape = (self.output_dim, H * W)
                if 3 in (a, b):
                    p = jnp.ones(shape, jnp.float32)
                else:
                    p = jax.random.uniform(keys[si, ci], shape, jnp.float32,
                                           0.1, 0.5)
                scale_planes.append(p)
            params.append(scale_planes)
        return params

    def _interp(self, params, pts, sample_only=None):
        """pts: [N, 4] in [0,1]. Returns static and/or dynamic features
        (``planes_field.py:86-140`` semantics, reduction='prod')."""
        ms_static, ms_dynamic = [], []
        for si in range(len(self.multiscale_res)):
            feat_s, feat_d = None, None
            for ci, (a, b) in enumerate(_COO_COMBS):
                is_dyn = 3 in (a, b)
                if sample_only == "static" and is_dyn:
                    continue
                if sample_only == "dynamic" and not is_dyn:
                    continue
                H, W = self.plane_hw(si, ci)
                f = _bilinear_remat(params[si][ci], H, W, pts[:, a],
                                    pts[:, b])
                if is_dyn:
                    feat_d = f if feat_d is None else feat_d * f
                else:
                    feat_s = f if feat_s is None else feat_s * f
            if feat_s is not None:
                ms_static.append(feat_s)
            if feat_d is not None:
                ms_dynamic.append(feat_d)
        # feature-major accumulation; transpose once at the end
        static = jnp.concatenate(ms_static, axis=0).T if ms_static else None
        dynamic = jnp.concatenate(ms_dynamic, axis=0).T if ms_dynamic \
            else None
        if sample_only == "static":
            return static
        if sample_only == "dynamic":
            return dynamic
        return static, dynamic

    # largest per-segment table sampled through ops/multihot.py; finer
    # static scales use per-plane gathers
    MULTIHOT_MAX_W = 4096

    def apply(self, params, xt):
        """xt: [N, 4] in [0,1] -> (static [N, 32], dynamic [N, 32])."""
        return (self.apply_static(params, xt),
                self.apply_dynamic(params, xt))

    def apply_static(self, params, xt):
        """Static (xy/xz/yz) group: coarse scales (tables <= MULTIHOT_MAX_W
        slots) sample via the 4-corner multi-corner sampler (positions
        carry no gradient here -> need_dw=False); fine scales keep
        per-plane bilinear gathers."""
        from nvsf_tpu.ops.multihot import multihot_sample

        S = len(self.multiscale_res)
        F = self.output_dim
        N = xt.shape[0]
        coarse = [si for si in range(S)
                  if max(self.plane_hw(si, ci)[0] * self.plane_hw(si, ci)[1]
                         for ci in _STATIC) <= self.MULTIHOT_MAX_W]
        fine = [si for si in range(S) if si not in coarse]

        per_scale = {}
        if coarse:
            tables, cols, ws = [], [], []
            for si in coarse:
                for ci in _STATIC:
                    a, b = _COO_COMBS[ci]
                    H, W = self.plane_hw(si, ci)
                    tables.append(jnp.pad(
                        params[si][ci],
                        ((0, 0), (0, self.MULTIHOT_MAX_W - H * W))))
                    c4, w4 = _bilinear_cols_weights(xt[:, a], xt[:, b], H, W)
                    cols.append(c4)
                    ws.append(w4)
            SP = len(tables)
            cols = jnp.stack(cols).reshape(1, SP, 4, N)
            ws = jnp.stack(ws).reshape(1, SP, 4, N)
            feats = multihot_sample(jnp.concatenate(tables, axis=1), cols,
                                    ws, self.MULTIHOT_MAX_W, need_dw=False)
            feats = feats[0].reshape(len(coarse), len(_STATIC),
                                               F, N)
            feats = jnp.prod(feats, axis=1)              # [n_coarse, F, N]
            for k, si in enumerate(coarse):
                per_scale[si] = feats[k]
        for si in fine:
            feat = None
            for ci in _STATIC:
                a, b = _COO_COMBS[ci]
                H, W = self.plane_hw(si, ci)
                f = _bilinear_sample_fmajor(params[si][ci], H, W, xt[:, a],
                                            xt[:, b])
                feat = f if feat is None else feat * f
            per_scale[si] = feat
        out = jnp.concatenate([per_scale[si] for si in range(S)], axis=0)
        return out.T                                     # [N, S*F]

    def apply_dynamic(self, params, xt):
        return self.apply_dynamic_multi(params, xt[None])[0]

    def apply_static_joint(self, params_list, xt_list):
        """``apply_static`` for several branches sharing ONE multi-corner
        sampler call (coarse scales) and fused per-plane gathers over
        lane-concatenated tables (fine scales). Returns one [N_i, S*F]
        array per branch; all branches' tables carry gradients."""
        from nvsf_tpu.ops.multihot import multihot_sample

        B = len(params_list)
        S = len(self.multiscale_res)
        F = self.output_dim
        ns = [xt.shape[0] for xt in xt_list]
        Np = max(ns)
        coarse = [si for si in range(S)
                  if max(self.plane_hw(si, ci)[0] * self.plane_hw(si, ci)[1]
                         for ci in _STATIC) <= self.MULTIHOT_MAX_W]
        fine = [si for si in range(S) if si not in coarse]

        per_branch_scale = [dict() for _ in range(B)]
        if coarse:
            tables, cols, ws = [], [], []
            for bi in range(B):
                for si in coarse:
                    for ci in _STATIC:
                        a, b = _COO_COMBS[ci]
                        H, W = self.plane_hw(si, ci)
                        tables.append(jnp.pad(
                            params_list[bi][si][ci],
                            ((0, 0), (0, self.MULTIHOT_MAX_W - H * W))))
                        c4, w4 = _bilinear_cols_weights(
                            xt_list[bi][:, a], xt_list[bi][:, b], H, W)
                        cols.append(jnp.pad(c4, ((0, 0),
                                                 (0, Np - ns[bi]))))
                        ws.append(jnp.pad(w4, ((0, 0), (0, Np - ns[bi]))))
            SP = len(tables)
            cols = jnp.stack(cols).reshape(1, SP, 4, Np)
            ws = jnp.stack(ws).reshape(1, SP, 4, Np)
            feats = multihot_sample(jnp.concatenate(tables, axis=1), cols,
                                    ws, self.MULTIHOT_MAX_W, need_dw=False)
            feats = feats[0].reshape(B, len(coarse),
                                                len(_STATIC), F, Np)
            feats = jnp.prod(feats, axis=2)     # [B, n_coarse, F, Np]
            for bi in range(B):
                for k, si in enumerate(coarse):
                    per_branch_scale[bi][si] = feats[bi, k, :, :ns[bi]]
        for si in fine:
            # one fused gather per plane across all branches: tables
            # lane-concatenated, branch points offset into their segment
            for ci in _STATIC:
                a, b = _COO_COMBS[ci]
                H, W = self.plane_hw(si, ci)
                tbl = jnp.concatenate([p[si][ci] for p in params_list],
                                      axis=1)              # [F, B*H*W]
                us = jnp.concatenate([xt[:, a] for xt in xt_list])
                vs = jnp.concatenate([xt[:, b] for xt in xt_list])
                # branch offset enters via the flat column id: shift v by
                # bi*H rows (tables stacked along columns = stacked rows
                # of the H*W grid when concatenated on axis 1)
                x = jnp.clip(us, 0.0, 1.0) * (W - 1)
                y = jnp.clip(vs, 0.0, 1.0) * (H - 1)
                x0 = jnp.floor(x).astype(jnp.int32)
                y0 = jnp.floor(y).astype(jnp.int32)
                x1 = jnp.minimum(x0 + 1, W - 1)
                y1 = jnp.minimum(y0 + 1, H - 1)
                wx = x - x0
                wy = y - y0
                off = jnp.concatenate([
                    jnp.full((n,), bi * H * W, jnp.int32)
                    for bi, n in enumerate(ns)])

                def g(yy, xx):
                    return tbl.at[:, yy * W + xx + off].get(
                        mode="promise_in_bounds")
                f = (g(y0, x0) * ((1 - wx) * (1 - wy))[None]
                     + g(y0, x1) * (wx * (1 - wy))[None]
                     + g(y1, x0) * ((1 - wx) * wy)[None]
                     + g(y1, x1) * (wx * wy)[None])     # [F, sum_n]
                p0 = 0
                for bi, n in enumerate(ns):
                    fb = f[:, p0:p0 + n]
                    p0 += n
                    cur = per_branch_scale[bi].get(si)
                    per_branch_scale[bi][si] = fb if cur is None \
                        else per_branch_scale[bi][si] * fb
        return [jnp.concatenate([per_branch_scale[bi][si]
                                 for si in range(S)], axis=0).T
                for bi in range(B)]

    # ------------------------------------------------------------------
    # dynamic (time) planes: scalar-t fold + multi-corner sampling
    # ------------------------------------------------------------------
    DYN_W_PAD = 256   # uniform folded-table lane width

    def apply_dynamic_multi(self, params, xts):
        """xts: [Q, N, 4] -> [Q, N, 32]: t-query + temporal-warp queries
        (``network_dynamic.py:245-271``).

        The time coordinate is SCALAR per query, so the t-lerp of each
        (x/y/z, t) plane folds into its table rows, leaving a 1-D lerp over
        tiny (<=256-col) tables, sampled in one call of
        ``ops/multihot.py`` for all queries, scales and planes. Gradients
        reach the tables and, through the lerp weights, the warped
        positions (the flow field)."""
        return self.apply_dynamic_multi_branches([params], [xts])[0]

    def apply_dynamic_multi_branches(self, params_list, xts_list):
        """``apply_dynamic_multi`` for SEVERAL branches (one params + one
        [Q_i, N_i, 4] query stack each) sharing ONE multi-corner sampler
        call — the joint LiDAR+camera step folds all 6 temporal queries
        into a single sampler dispatch. Returns one [Q_i, N_i, 32] array
        per branch."""
        from nvsf_tpu.ops.multihot import multihot_sample

        B = len(params_list)
        F = self.output_dim
        S = len(self.multiscale_res)
        W_PAD = self.DYN_W_PAD
        qs = [xts.shape[0] for xts in xts_list]
        ns = [xts.shape[1] for xts in xts_list]
        Np = max(ns)

        folded, cols, ws = [], [], []
        for bi in range(B):
            params, xts = params_list[bi], xts_list[bi]
            for q in range(qs[bi]):
                t = xts[q, 0, 3]
                for si in range(S):
                    for ci in _DYNAMIC:
                        a, _b = _COO_COMBS[ci]
                        H, W = self.plane_hw(si, ci)
                        assert W <= W_PAD, (
                            f"dynamic plane (scale {si}, plane {ci}) "
                            f"spatial width {W} exceeds the "
                            f"sampler width DYN_W_PAD={W_PAD}; reduce "
                            f"resolution x multiscale factor or raise "
                            f"Planes4DSpec.DYN_W_PAD")
                        # fold the scalar-t lerp into the table rows
                        y = jnp.clip(t, 0.0, 1.0) * (H - 1)
                        y0 = jnp.floor(y).astype(jnp.int32)
                        y1 = jnp.minimum(y0 + 1, H - 1)
                        wy = (y - y0.astype(jnp.float32))[None, None]
                        tbl = params[si][ci]                  # [F, H*W]
                        r0 = jax.lax.dynamic_slice(tbl, (0, y0 * W), (F, W))
                        r1 = jax.lax.dynamic_slice(tbl, (0, y1 * W), (F, W))
                        folded.append(jnp.pad((1.0 - wy) * r0 + wy * r1,
                                              ((0, 0), (0, W_PAD - W))))
                        # per-sample x lerp
                        x = jnp.clip(xts[q, :, a], 0.0, 1.0) * (W - 1)
                        x0 = jnp.floor(x).astype(jnp.int32)
                        x1 = jnp.minimum(x0 + 1, W - 1)
                        wx = x - x0.astype(jnp.float32)
                        npad = Np - ns[bi]
                        cols.append(jnp.pad(jnp.stack([x0, x1]),
                                            ((0, 0), (0, npad))))
                        ws.append(jnp.pad(jnp.stack([1.0 - wx, wx]),
                                          ((0, 0), (0, npad))))

        tables = jnp.concatenate(folded, axis=1)     # [F, sumQ*12*W_PAD]
        SP = S * len(_DYNAMIC)
        Qt = sum(qs)

        def prep(parts, dtype):
            return jnp.stack(parts).reshape(Qt, SP, 2, Np).astype(dtype)

        feats = multihot_sample(tables, prep(cols, jnp.int32),
                                prep(ws, jnp.float32), W_PAD)
        feats = feats.reshape(Qt, S, len(_DYNAMIC), F, Np)
        feats = jnp.prod(feats, axis=2)              # [Qt, S, F, Np]
        # -> [Qt, Np, S*F] scale-major features
        feats = jnp.transpose(feats.reshape(Qt, S * F, Np), (0, 2, 1))
        outs, q0 = [], 0
        for bi in range(B):
            outs.append(feats[q0:q0 + qs[bi], :ns[bi]])
            q0 += qs[bi]
        return outs
