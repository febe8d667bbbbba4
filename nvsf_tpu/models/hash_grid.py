"""Multi-resolution hash-grid encodings in pure JAX (instant-ngp family).

Replaces the reference's external tiny-cuda-nn ``HashGrid`` encodings:
  - static 3D grid  (``hash_field.py:108-119``)
  - time-binned 2D grids ``HashGridT`` (``hash_field.py:29-88``)
  - the 4D composite ``HashGrid4D`` (``hash_field.py:92-173``)
  - the flow field's 3D grid + temporal Lagrange basis
    (``flow_field.py:68-84,105-114``)

Design notes:
  - Tables are stored as single 2D arrays [F, L*T] (features x concatenated
    per-level tables): ALL levels' lookups become one fused gather. Levels
    whose dense grid fits in T entries are dense-indexed; finer levels use
    the instant-ngp spatial hash.
  - Gathers go through ``nvsf_tpu.ops.gather.table_gather``: forward is the
    XLA gather; backward is the XLA scatter-add of
    ``nvsf_tpu/ops/segsum.py``.
  - TIME FOLDING: within one training/render step the query time t is a
    SCALAR, and everything the reference does after the lookup — the
    adjacent-time-bin lerp of ``HashGridT.forward`` and the Lagrange
    feature-basis blend of ``interpT`` (``hash_field.py:56-88``) — is a
    LINEAR map with t-dependent scalar coefficients. Both are folded into
    the table BEFORE the gather (a dense table-sized contraction, ~free),
    so each sample gathers ONE row of F/num_basis features instead of two
    rows of F: half the forward rows, quarter the backward sort payload.
  - The three dynamic planes (xyt/xzt/yzt) AND all three temporal queries
    (t plus both no-grad warp queries) share ONE fused gather
    (``apply_dynamic_fused3``); a partial-grad VJP keeps the stop-grad
    warp rows out of the backward segment-sum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nvsf_tpu.ops.gather import table_gather

_PRIMES = (1, 2654435761, 805459861, 3674653429)


def level_resolutions(base_resolution: int, max_resolution: int, n_levels: int):
    """Per-level grid resolutions with tcnn's geometric spacing
    (``hash_field.py:43,108``)."""
    if n_levels == 1:
        return [int(base_resolution)]
    s = math.exp2(math.log2(max_resolution / base_resolution) / (n_levels - 1))
    return [int(math.floor(base_resolution * (s ** l))) for l in range(n_levels)]


def lagrange_basis(t, num_basis: int):
    """Lagrange basis weights at normalized time t over nodes
    linspace(0, 1, num_basis) (``hash_field.py:65-74``)."""
    nodes = [i / (num_basis - 1) for i in range(num_basis)]
    t = jnp.asarray(t, jnp.float32)
    out = []
    for j in range(num_basis):
        basis = jnp.float32(1.0)
        for m in range(num_basis):
            if m != j:
                basis = basis * (t - nodes[m]) / (nodes[j] - nodes[m])
        out.append(basis)
    return jnp.stack(out)  # [num_basis]


def lagrange_fold_table(table: jnp.ndarray, t, num_basis: int) -> jnp.ndarray:
    """Fold the Lagrange feature-basis blend into the table rows.

    table: [F, C] with rows grouped in ``num_basis`` chunks of F/num_basis
    -> [F/num_basis, C]. Gathering a row of the folded table equals
    gathering all F features and applying ``interpT``'s basis blend.
    """
    F, C = table.shape
    basis = lagrange_basis(t, num_basis)
    tb = table.reshape(num_basis, F // num_basis, C)
    return jnp.tensordot(basis, tb, axes=1)  # [F/num_basis, C]


def lagrange_interp_features(x: jnp.ndarray, t, n_levels: int,
                             n_features_per_level: int,
                             num_basis: int = 4) -> jnp.ndarray:
    """Post-gather variant of the Lagrange blend (``hash_field.py:65-74``),
    kept for tests/reference: view features as [N, L, F], chunk F into
    ``num_basis`` groups, blend with the basis. Output dim = L * F / B."""
    N = x.shape[0]
    F = n_features_per_level
    B = num_basis
    xv = x.reshape(N, n_levels, F)
    basis = lagrange_basis(t, B)
    chunks = jnp.split(xv, B, axis=-1)
    out = sum(basis[j] * chunks[j] for j in range(B))
    return out.reshape(N, n_levels * F // B)


@dataclass(frozen=True)
class HashEncodingSpec:
    """One multi-resolution hash encoding over D-dim inputs in [0, 1]^D."""
    dim: int = 3
    n_levels: int = 8
    n_features_per_level: int = 4
    log2_hashmap_size: int = 19
    base_resolution: int = 512
    max_resolution: int = 32768
    remat_gather: bool = False  # kept for config compat; gather residuals
                                # are just int32 cols now, so remat is moot

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def resolutions(self):
        return level_resolutions(self.base_resolution, self.max_resolution,
                                 self.n_levels)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_cols(self) -> int:
        """Total table columns (all levels concatenated)."""
        return self.n_levels * self.table_size

    def init(self, key):
        # tcnn init: U(-1e-4, 1e-4). Stored [F, L*T]: all levels' lookups
        # are one gather along the column axis.
        return jax.random.uniform(
            key,
            (self.n_features_per_level, self.n_levels * self.table_size),
            jnp.float32, -1e-4, 1e-4)

    # ------------------------------------------------------------------
    def level_cols_weights(self, x: jnp.ndarray):
        """Index math shared by all gather paths.

        x: [N, D] in [0, 1] -> (cols [L*C*N] int32 global column ids,
        wc [L, C, N] trilinear corner weights). Large intermediates keep N
        last.
        """
        D = self.dim
        L = self.n_levels
        T = self.table_size
        n_corners = 1 << D
        N = x.shape[0]
        offs = np.stack(np.meshgrid(*([np.arange(2)] * D), indexing="ij"),
                        axis=-1).reshape(-1, D)
        offs = jnp.asarray(offs, dtype=jnp.int32)
        res_arr = jnp.asarray(self.resolutions, jnp.int32)
        dense_arr = jnp.asarray(
            [(r + 1) ** D <= T for r in self.resolutions])
        level_offs = jnp.arange(L, dtype=jnp.int32) * T

        pos = x.astype(jnp.float32)[:, None, :] \
            * res_arr[None, :, None].astype(jnp.float32)     # [N, L, D]
        c0 = jnp.floor(pos)
        w = pos - c0                                          # [N, L, D]
        c0 = c0.astype(jnp.int32)
        corners = jnp.clip(c0[:, :, None, :] + offs[None, None, :, :],
                           0, res_arr[None, :, None, None])   # [N, L, C, D]
        idx_dense = corners[..., 0]
        stride = jnp.ones_like(res_arr)
        for d in range(1, D):
            stride = stride * (res_arr + 1)
            idx_dense = idx_dense + corners[..., d] * stride[None, :, None]
        h = corners[..., 0].astype(jnp.uint32) * jnp.uint32(_PRIMES[0])
        for d in range(1, D):
            h = h ^ (corners[..., d].astype(jnp.uint32)
                     * jnp.uint32(_PRIMES[d]))
        idx_hash = (h & jnp.uint32(T - 1)).astype(jnp.int32)
        idx = jnp.where(dense_arr[None, :, None], idx_dense, idx_hash)
        cols = idx + level_offs[None, :, None]                # [N, L, C]
        cols = jnp.transpose(cols, (1, 2, 0)).reshape(-1)     # [L*C*N]

        wc = jnp.ones((L, n_corners, N), jnp.float32)
        wt = jnp.transpose(w, (1, 2, 0))                      # [L, D, N]
        for d in range(D):
            wd = jnp.where(offs[None, :, d:d + 1] == 1,
                           wt[:, None, d, :], 1.0 - wt[:, None, d, :])
            wc = wc * wd
        return cols, wc

    def interp(self, table: jnp.ndarray, cols: jnp.ndarray,
               wc: jnp.ndarray) -> jnp.ndarray:
        """Gather + corner-weight reduce. table [F', cols_total] (F' may be
        a folded feature count); returns [N, L*F'] level-major."""
        L, C, N = wc.shape
        vals = table_gather(table, cols)
        Fp = vals.shape[0]
        vals = vals.reshape(Fp, L, C, N)
        feat = jnp.sum(vals * wc[None], axis=2)               # [F', L, N]
        return jnp.transpose(feat, (2, 1, 0)).reshape(N, L * Fp)

    def apply(self, table: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """x: [N, D] in [0, 1] -> [N, L * F] features (level-major order,
        matching tcnn's concatenation)."""
        cols, wc = self.level_cols_weights(x)
        return self.interp(table, cols, wc)


@dataclass(frozen=True)
class HashGridTSpec:
    """Time-binned 2D hash grids with linear interp across adjacent bins
    plus Lagrange feature-basis interp (``hash_field.py:29-88``).

    Redesign: t is scalar per query batch, so the bin lerp AND the
    Lagrange blend are folded into one [F/B, L*T] table before the gather
    (see module docstring) — one narrow row per corner instead of two wide
    ones, and a 4x narrower backward segment-sum.
    """
    time_resolution: int = 8
    base_resolution: int = 512
    max_resolution: int = 32768
    n_levels: int = 8
    n_features_per_level: int = 4
    log2_hashmap_size: int = 14
    num_basis: int = 4
    remat_gather: bool = False

    @property
    def grid(self) -> HashEncodingSpec:
        return HashEncodingSpec(
            dim=2, n_levels=self.n_levels,
            n_features_per_level=self.n_features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
            remat_gather=self.remat_gather)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level // self.num_basis

    def init(self, key):
        keys = jax.random.split(key, self.time_resolution)
        return jnp.stack([self.grid.init(k) for k in keys])  # [TR, F, L*T]

    def folded_table(self, tables: jnp.ndarray, t) -> jnp.ndarray:
        """Blend adjacent time bins (``hash_field.py:76-88``) and fold the
        Lagrange basis: [TR, F, L*T] -> [F/B, L*T] for scalar t."""
        t = jnp.asarray(t, jnp.float32).reshape(())
        idx = t * (self.time_resolution - 1)
        i1 = jnp.floor(idx).astype(jnp.int32)
        i2 = jnp.minimum(i1 + 1, self.time_resolution - 1)
        w2 = idx - i1.astype(jnp.float32)
        t1 = jax.lax.dynamic_index_in_dim(tables, i1, 0, keepdims=False)
        t2 = jax.lax.dynamic_index_in_dim(tables, i2, 0, keepdims=False)
        blended = (1.0 - w2) * t1 + w2 * t2                   # [F, L*T]
        return lagrange_fold_table(blended, t, self.num_basis)

    def apply(self, tables: jnp.ndarray, x: jnp.ndarray, t) -> jnp.ndarray:
        """x: [N, 2] in [0,1]; t: scalar in [0,1] -> [N, n_output_dims]."""
        folded = self.folded_table(tables, t)
        return self.grid.apply(folded, x)


@dataclass(frozen=True)
class HashGrid4DSpec:
    """Static 3D hash + three time-binned 2D planes (xyt, xzt, yzt)
    (``hash_field.py:92-173``)."""
    base_resolution: int = 512
    max_resolution: int = 32768
    time_resolution: int = 8
    n_levels: int = 8
    n_features_per_level: int = 4
    log2_hashmap_size: int = 19
    hash_size_dynamic: Tuple[int, int, int] = (15, 13, 13)  # larger for xy
    remat_gather: bool = False

    @property
    def static_grid(self) -> HashEncodingSpec:
        return HashEncodingSpec(
            dim=3, n_levels=self.n_levels,
            n_features_per_level=self.n_features_per_level,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
            remat_gather=self.remat_gather)

    def dynamic_grid(self, i: int) -> HashGridTSpec:
        return HashGridTSpec(
            time_resolution=self.time_resolution,
            base_resolution=self.base_resolution,
            max_resolution=self.max_resolution,
            n_levels=self.n_levels,
            n_features_per_level=self.n_features_per_level,
            log2_hashmap_size=self.hash_size_dynamic[i],
            remat_gather=self.remat_gather)

    _PLANE_KEYS = ("dyn_xyt", "dyn_xzt", "dyn_yzt")
    _PLANE_AXES = ((0, 1), (0, 2), (1, 2))

    @property
    def n_output_dims_static(self) -> int:
        return self.static_grid.n_output_dims  # 32

    @property
    def n_output_dims_dynamic(self) -> int:
        return self.dynamic_grid(0).n_output_dims * 3  # 24 (concat reduction)

    def init(self, key):
        ks, k0, k1, k2 = jax.random.split(key, 4)
        return {
            "static": self.static_grid.init(ks),
            "dyn_xyt": self.dynamic_grid(0).init(k0),
            "dyn_xzt": self.dynamic_grid(1).init(k1),
            "dyn_yzt": self.dynamic_grid(2).init(k2),
        }

    def apply_static(self, params, x):
        return self.static_grid.apply(params["static"], x)

    def apply_static_joint(self, params_list, x_list):
        """Static 3D hash for SEVERAL branches (e.g. LiDAR + camera) in ONE
        fused gather: per-branch tables are lane-concatenated and every
        branch's corner columns offset into its segment. Both branches'
        tables carry gradients (one backward segment-sum over the
        concatenated width).

        Matches the per-branch encoder selection of
        ``network_dynamic.py:67-105`` with shared gather machinery.
        Returns one [N_i, L*F] feature array per branch."""
        gspec = self.static_grid
        S = gspec.n_cols
        cols_all, wcs, ns = [], [], []
        for bi, x in enumerate(x_list):
            cols, wc = gspec.level_cols_weights(x)
            cols_all.append(cols + bi * S)
            wcs.append(wc)
            ns.append(cols.shape[0])
        table = jnp.concatenate([p["static"] for p in params_list], axis=1)
        vals = table_gather(table, jnp.concatenate(cols_all))
        outs, p = [], 0
        for wc, n in zip(wcs, ns):
            L, C, N = wc.shape
            v = vals[:, p:p + n].reshape(-1, L, C, N)
            p += n
            feat = jnp.sum(v * wc[None], axis=2)
            outs.append(jnp.transpose(feat, (2, 1, 0)).reshape(N, -1))
        return outs

    # ------------------------------------------------------------------
    def _dynamic_cols_weights(self, x):
        """Concatenated global columns + weights for the 3 dynamic planes."""
        cols_all, wcs = [], []
        offset = 0
        for i, (a, b) in enumerate(self._PLANE_AXES):
            gspec = self.dynamic_grid(i).grid
            cols, wc = gspec.level_cols_weights(x[:, (a, b)])
            cols_all.append(cols + offset)
            wcs.append(wc)
            offset += gspec.n_cols
        return jnp.concatenate(cols_all), wcs

    def _dynamic_folded(self, params, t):
        """One folded [F/B, sum_cols] table for all 3 planes at scalar t."""
        return jnp.concatenate([
            self.dynamic_grid(i).folded_table(params[k], t)
            for i, k in enumerate(self._PLANE_KEYS)], axis=1)

    def _assemble(self, vals, wcs):
        """Per-plane corner-weight reduce of a fused gather result."""
        outs = []
        p = 0
        for wc in wcs:
            L, C, N = wc.shape
            n = L * C * N
            v = vals[:, p:p + n].reshape(-1, L, C, N)
            p += n
            feat = jnp.sum(v * wc[None], axis=2)              # [F', L, N]
            outs.append(jnp.transpose(feat, (2, 1, 0)).reshape(N, -1))
        return jnp.concatenate(outs, axis=-1)                 # [N, 3*L*F']

    def apply_dynamic(self, params, x, t):
        """x: [N, 3] in [0,1]; scalar t -> [N, n_output_dims_dynamic].
        One gather (and one backward segment-sum) for all three planes."""
        cols, wcs = self._dynamic_cols_weights(x)
        table = self._dynamic_folded(params, t)
        return self._assemble(table_gather(table, cols), wcs)

    def apply_dynamic_pair(self, params, xs, ts):
        """Both temporal-warp queries (``network_dynamic.py:245-271``).

        xs: [2, N, 3]; ts: [2] (scalars) -> [2, N, n_output_dims_dynamic].
        """
        return jnp.stack([self.apply_dynamic(params, xs[0], ts[0]),
                          self.apply_dynamic(params, xs[1], ts[1])])

    def apply_dynamic_fused3(self, params, x, x1, x2, t, t1, t2):
        """The t-query and BOTH temporal-warp queries in ONE fused gather.

        The three queries' columns are concatenated against the three
        folded tables.
        Only the t-query carries gradients (``n_grad``); the warp queries
        replicate the reference's ``torch.no_grad`` re-queries
        (``network_dynamic.py:245-271``) — their positions, tables, and
        gathered values are all stop-gradient.

        Returns (feat_t, feat_t1, feat_t2), each [N, n_output_dims_dynamic].
        """
        sg = jax.lax.stop_gradient
        cols0, wcs0 = self._dynamic_cols_weights(x)
        cols1, wcs1 = self._dynamic_cols_weights(sg(x1))
        cols2, wcs2 = self._dynamic_cols_weights(sg(x2))
        tb0 = self._dynamic_folded(params, t)
        tb1 = sg(self._dynamic_folded(sg(params), t1))
        tb2 = sg(self._dynamic_folded(sg(params), t2))
        S = tb0.shape[1]
        table = jnp.concatenate([tb0, tb1, tb2], axis=1)
        n = cols0.shape[0]
        cols = jnp.concatenate([cols0, cols1 + S, cols2 + 2 * S])
        vals = table_gather(table, cols, n_grad=n, grad_cols_T=S)
        out0 = self._assemble(vals[:, :n], wcs0)
        out1 = self._assemble(sg(vals[:, n:2 * n]), wcs1)
        out2 = self._assemble(sg(vals[:, 2 * n:]), wcs2)
        return out0, out1, out2

    def apply_dynamic_fused3_joint(self, params_list, xs_list, t, t1, t2):
        """``apply_dynamic_fused3`` for SEVERAL branches in ONE gather.

        params_list: per-branch params; xs_list: per-branch (x, x1, x2)
        query positions. Row order is [b0_t, b1_t, ..., b0_t1, b0_t2,
        b1_t1, b1_t2, ...]: all gradient-carrying t-queries form the row
        prefix and their tables the column prefix, so the existing
        ``n_grad``/``grad_cols_T`` partial-grad VJP covers every branch
        with one backward segment-sum. Warp queries stay stop-gradient
        (reference ``torch.no_grad`` re-queries,
        ``network_dynamic.py:245-271``).

        Returns a list of (feat_t, feat_t1, feat_t2) per branch."""
        sg = jax.lax.stop_gradient
        B = len(params_list)
        S = None
        grad_cols, grad_tbls, grad_wcs, grad_ns = [], [], [], []
        warp_cols, warp_tbls, warp_wcs, warp_ns = [], [], [], []
        for bi, (params, (x, x1, x2)) in enumerate(zip(params_list,
                                                       xs_list)):
            cols0, wcs0 = self._dynamic_cols_weights(x)
            tb0 = self._dynamic_folded(params, t)
            if S is None:
                S = tb0.shape[1]
            grad_cols.append(cols0 + bi * S)
            grad_tbls.append(tb0)
            grad_wcs.append(wcs0)
            grad_ns.append(cols0.shape[0])
            for xw, tw in ((x1, t1), (x2, t2)):
                colsw, wcsw = self._dynamic_cols_weights(sg(xw))
                warp_cols.append(colsw)          # offset applied below
                warp_tbls.append(sg(self._dynamic_folded(sg(params), tw)))
                warp_wcs.append(wcsw)
                warp_ns.append(colsw.shape[0])
        # warp tables sit AFTER the B grad tables in the lane concat
        warp_cols = [c + (B + wi) * S for wi, c in enumerate(warp_cols)]
        table = jnp.concatenate(grad_tbls + warp_tbls, axis=1)
        cols = jnp.concatenate(grad_cols + warp_cols)
        n_grad = sum(grad_ns)
        vals = table_gather(table, cols, n_grad=n_grad, grad_cols_T=B * S)
        outs_t, p = [], 0
        for wcs, n in zip(grad_wcs, grad_ns):
            outs_t.append(self._assemble(vals[:, p:p + n], wcs))
            p += n
        outs_w = []
        for wcs, n in zip(warp_wcs, warp_ns):
            outs_w.append(self._assemble(sg(vals[:, p:p + n]), wcs))
            p += n
        return [(outs_t[bi], outs_w[2 * bi], outs_w[2 * bi + 1])
                for bi in range(B)]

    def apply(self, params, x, t):
        return self.apply_static(params, x), self.apply_dynamic(params, x, t)
