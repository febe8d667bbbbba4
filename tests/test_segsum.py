"""Table-gradient segment-add and the custom-VJP table gather: the API
contract and the VJP algebra against numpy and autodiff references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvsf_tpu.ops.gather import table_gather
from nvsf_tpu.ops.segsum import segment_add_fm


def test_segment_add_matches_scatter():
    key = jax.random.PRNGKey(0)
    cols = jax.random.randint(key, (4096,), 0, 300, jnp.int32)
    vals = jax.random.normal(key, (6, 4096), jnp.float32)
    got = segment_add_fm(cols, vals, 300)
    ref = np.zeros((300, 6))
    np.add.at(ref, np.asarray(cols), np.asarray(vals, np.float64).T)
    assert got.shape == (6, 300)
    # float32 sums of ~14 unit normals per slot
    np.testing.assert_allclose(np.asarray(got), ref.T, atol=1e-5)


def test_table_gather_forward():
    key = jax.random.PRNGKey(2)
    table = jax.random.normal(key, (8, 512), jnp.float32)
    cols = jax.random.randint(key, (1000,), 0, 512, jnp.int32)
    np.testing.assert_allclose(np.asarray(table_gather(table, cols)),
                               np.asarray(jnp.take(table, cols, axis=1)))


def test_table_gather_vjp_matches_autodiff():
    key = jax.random.PRNGKey(3)
    table = jax.random.normal(key, (4, 256), jnp.float32)
    cols = jax.random.randint(key, (513,), 0, 256, jnp.int32)
    w = jax.random.normal(key, (513,), jnp.float32)

    def loss_custom(tb):
        return jnp.sum(jnp.tanh(table_gather(tb, cols)) * w)

    def loss_ref(tb):
        return jnp.sum(jnp.tanh(jnp.take(tb, cols, axis=1)) * w)

    g1 = jax.grad(loss_custom)(table)
    g2 = jax.grad(loss_ref)(table)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-5)


def test_table_gather_under_checkpoint_and_jit():
    key = jax.random.PRNGKey(4)
    table = jax.random.normal(key, (2, 128), jnp.float32)
    cols = jax.random.randint(key, (64,), 0, 128, jnp.int32)

    @jax.jit
    def loss(tb):
        f = jax.checkpoint(lambda t: table_gather(t, cols).sum())
        return f(tb)

    g = jax.grad(loss)(table)
    ref = jax.grad(lambda t: jnp.take(t, cols, axis=1).sum())(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref), atol=1e-6)


def test_table_gather_prefix_backward_matches_autodiff():
    """Fused gather where only the first n_grad rows carry gradients and
    those rows index the first grad_cols_T columns: the custom backward
    equals autodiff of a take whose suffix rows are stop-gradient."""
    key = jax.random.PRNGKey(5)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    T, grad_T, n_grad = 512, 192, 300
    table = jax.random.normal(k1, (4, T), jnp.float32)
    cols = jnp.concatenate([
        jax.random.randint(k2, (n_grad,), 0, grad_T, jnp.int32),
        jax.random.randint(k3, (200,), 0, T, jnp.int32)])
    w = jax.random.normal(k4, (cols.shape[0],), jnp.float32)

    def loss_custom(tb):
        return jnp.sum(jnp.tanh(table_gather(tb, cols, n_grad=n_grad,
                                             grad_cols_T=grad_T)) * w)

    def loss_ref(tb):
        head = jnp.take(tb, cols[:n_grad], axis=1)
        tail = jax.lax.stop_gradient(jnp.take(tb, cols[n_grad:], axis=1))
        return jnp.sum(jnp.tanh(jnp.concatenate([head, tail], 1)) * w)

    np.testing.assert_allclose(float(loss_custom(table)),
                               float(loss_ref(table)), rtol=1e-6)
    g1 = np.asarray(jax.grad(loss_custom)(table))
    g2 = np.asarray(jax.grad(loss_ref)(table))
    np.testing.assert_allclose(g1, g2, atol=1e-5)
    assert (g1[:, grad_T:] == 0).all()
