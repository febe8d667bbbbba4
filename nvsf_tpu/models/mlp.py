"""Small MLPs (pure-pytree params).

Replaces the reference's tcnn ``FullyFusedMLP`` heads
(``network_dynamic.py:125-189``): 64-wide ReLU MLPs as plain matmuls that
XLA compiles and fuses under jit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class MLPSpec:
    """n_layers linear layers (n_layers-1 ReLUs), optionally bias-free.

    Matches tcnn.Network(otype=FullyFusedMLP, activation=ReLU,
    output_activation=None) with ``n_hidden_layers = n_layers - 1``.
    """
    in_dim: int
    hidden_dim: int
    out_dim: int
    n_layers: int = 3
    bias: bool = False
    last_init_std: Optional[float] = None  # e.g. 1e-3 for the flow head

    def init(self, key):
        params = []
        dims = ([self.in_dim] + [self.hidden_dim] * (self.n_layers - 1)
                + [self.out_dim])
        keys = jax.random.split(key, self.n_layers)
        for li in range(self.n_layers):
            fan_in, fan_out = dims[li], dims[li + 1]
            if li == self.n_layers - 1 and self.last_init_std is not None:
                w = self.last_init_std * jax.random.normal(
                    keys[li], (fan_in, fan_out), dtype=jnp.float32)
            else:
                # He-uniform (torch nn.Linear default is kaiming-uniform)
                bound = (6.0 / fan_in) ** 0.5
                w = jax.random.uniform(
                    keys[li], (fan_in, fan_out), jnp.float32, -bound, bound)
            layer = {"w": w}
            if self.bias:
                layer["b"] = jnp.zeros((fan_out,), jnp.float32)
            params.append(layer)
        return params

    def apply(self, params, x, compute_dtype=jnp.float32):
        h = x.astype(compute_dtype)
        for li, layer in enumerate(params):
            h = h @ layer["w"].astype(compute_dtype)
            if self.bias:
                h = h + layer["b"].astype(compute_dtype)
            if li != len(params) - 1:
                h = jax.nn.relu(h)
        return h

    def apply_blocks(self, params, blocks, compute_dtype=jnp.float32):
        """Like ``apply(params, concat(blocks, -1))`` WITHOUT the concat.

        The first linear layer is linear in each block, so its weight rows
        are split per block and the partial matmuls summed instead of
        concatenating narrow feature blocks along the minor dim: zero
        concat, same math.
        """
        w0 = params[0]["w"]
        h = None
        off = 0
        for blk in blocks:
            wslice = w0[off:off + blk.shape[-1]].astype(compute_dtype)
            part = blk.astype(compute_dtype) @ wslice
            h = part if h is None else h + part
            off += blk.shape[-1]
        assert off == self.in_dim, (off, self.in_dim)
        if self.bias:
            h = h + params[0]["b"].astype(compute_dtype)
        if len(params) > 1:
            h = jax.nn.relu(h)
        for li, layer in enumerate(params[1:], start=1):
            h = h @ layer["w"].astype(compute_dtype)
            if self.bias:
                h = h + layer["b"].astype(compute_dtype)
            if li != len(params) - 1:
                h = jax.nn.relu(h)
        return h
