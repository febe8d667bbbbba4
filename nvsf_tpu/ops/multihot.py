"""Weighted multi-corner sampling of many small per-segment tables.

Generalization of the time-folded K-plane sampler: for C corners,

  forward : feat[n] = sum_c  w[c, n] * T[cols[c, n]]
  backward: dT = scatter-add of w * g      dw[c, n] = <T[:, cols[c, n]], g[:, n]>

over a set of per-(query, segment) tables laid side by side in one
features-major array. Serves the dynamic (time-folded) K-planes (C=2 lerp
corners over W<=256 columns) and the coarse static K-plane scales (C=4
bilinear corners over W=H*W<=4096). One gather over the concatenated
tables replaces one small gather per plane; autodiff gives both gradient
paths (tables, and the sample weights through which the flow field
learns).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def multihot_sample(tables, cols, ws, seg_width: int, need_dw: bool = True):
    """tables: [F, Q * S * seg_width] side-by-side per-(query, segment)
    tables; cols: [Q, S, C, Np] int32 LOCAL columns in [0, seg_width);
    ws: matching f32 weights.
    Returns [Q, S, F, Np] = sum_c ws_c * T[cols_c].
    Gradients flow to ``tables`` and (when ``need_dw``) ``ws`` — pass
    need_dw=False when the sample positions carry no gradient (e.g. the
    unwarped static-plane query)."""
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    assert tables.shape[1] == Q * S * seg_width, (tables.shape, Q, S,
                                                  seg_width)
    if not need_dw:
        ws = jax.lax.stop_gradient(ws)
    seg = (jnp.arange(Q * S, dtype=jnp.int32) * seg_width).reshape(Q, S, 1, 1)
    g = (cols + seg).reshape(-1)
    v = tables.at[:, g].get(mode="promise_in_bounds")     # [F, Q*S*C*Np]
    v = v.reshape(F, Q, S, C, Np)
    out = jnp.sum(ws[None] * v, axis=3)                   # [F, Q, S, Np]
    return jnp.moveaxis(out, 0, 2)                        # [Q, S, F, Np]
