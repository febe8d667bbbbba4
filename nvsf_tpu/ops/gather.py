"""Table gather with a custom VJP.

``table_gather(table, cols)`` == ``jnp.take(table, cols, axis=1)`` for a
features-major table ``[F, T]``; its backward is the scatter-add
``nvsf_tpu.ops.segsum.segment_add_fm``. This stands in for tiny-cuda-nn's
fused encoder forward/backward (reference ``nerf/models/hash_field.py:108-133``
via tcnn).

``n_grad`` supports FUSED gathers where only a prefix of the rows carries
gradients: the temporal-warp hash queries (reference ``torch.no_grad``,
``network_dynamic.py:245-271``) ride in the same gather as the t-query,
while the backward accumulates ONLY the grad-carrying prefix. The
cotangent of the stop-grad suffix never reaches the scatter.

The VJP residual is just the int32 column vector — the gathered corner
values are never saved, so encoder memory does not force
rematerialization at large ray batches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nvsf_tpu.ops.segsum import segment_add_fm


@functools.lru_cache(maxsize=None)
def _make_gather(T: int, dtype_name: str, n_grad, grad_cols_T):
    dtype = jnp.dtype(dtype_name)

    @jax.custom_vjp
    def gather(table, cols):
        # promise_in_bounds: cols are constructed in-range; the default
        # 'fill' mode adds a bounds select around every gathered row
        return table.at[:, cols].get(mode="promise_in_bounds")

    def fwd(table, cols):
        return table.at[:, cols].get(mode="promise_in_bounds"), cols

    def bwd(cols, g):
        if n_grad is None:
            d_table = segment_add_fm(cols, g.astype(jnp.float32), T)
        else:
            # only the first n_grad rows carry gradients, and their columns
            # lie in [0, grad_cols_T) (the first table segment of a fused
            # multi-query gather)
            d_seg = segment_add_fm(cols[:n_grad],
                                   g[:, :n_grad].astype(jnp.float32),
                                   grad_cols_T)
            d_table = jnp.pad(d_seg, ((0, 0), (0, T - grad_cols_T)))
        return d_table.astype(dtype), None

    gather.defvjp(fwd, bwd)
    return gather


def table_gather(table: jnp.ndarray, cols: jnp.ndarray,
                 n_grad: int | None = None,
                 grad_cols_T: int | None = None) -> jnp.ndarray:
    """table: [F, T]; cols: [M] int32 -> [F, M].

    With ``n_grad``, only rows ``cols[:n_grad]`` propagate table gradients,
    and those columns must lie in [0, grad_cols_T) (default: whole table).
    """
    T = table.shape[1]
    if n_grad is not None and grad_cols_T is None:
        grad_cols_T = T
    return _make_gather(T, jnp.result_type(table).name, n_grad,
                        grad_cols_T)(table, cols)
