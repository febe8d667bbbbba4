"""Multi-corner table sampling: forward and gradients (tables AND weights)
against explicit gathers, and the plane fast paths vs the reference
bilinear."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nvsf_tpu.ops import multihot as mh

W_SEG = 256


def _inputs(key, Q=2, S=3, C=2, Np=512, F=4):
    ks = jax.random.split(key, 3)
    tables = jax.random.normal(ks[0], (F, Q * S * W_SEG), jnp.float32)
    cols = jax.random.randint(ks[1], (Q, S, C, Np), 0, W_SEG, jnp.int32)
    ws = jax.random.uniform(ks[2], (Q, S, C, Np), jnp.float32)
    return tables, cols, ws


def test_xla_path_matches_manual():
    tables, cols, ws = _inputs(jax.random.PRNGKey(0))
    out = mh.multihot_sample(tables, cols, ws, W_SEG)
    Q, S, C, Np = cols.shape
    for q in range(Q):
        for s in range(S):
            seg = tables[:, (q * S + s) * W_SEG:(q * S + s + 1) * W_SEG]
            ref = sum(ws[q, s, c] * seg[:, cols[q, s, c]] for c in range(C))
            np.testing.assert_allclose(np.asarray(out[q, s]),
                                       np.asarray(ref), atol=1e-5)


def _explicit(tables, cols, ws):
    """Reference: one gather per (query, segment), summed over corners."""
    Q, S, C, _ = cols.shape
    outs = []
    for q in range(Q):
        row = []
        for s in range(S):
            seg = tables[:, (q * S + s) * W_SEG:(q * S + s + 1) * W_SEG]
            row.append(sum(ws[q, s, c] * jnp.take(seg, cols[q, s, c], axis=1)
                           for c in range(C)))
        outs.append(jnp.stack(row))
    return jnp.stack(outs)                               # [Q, S, F, Np]


@pytest.mark.parametrize("need_dw", [True, False])
def test_gradients_match_explicit_gather(need_dw):
    """Table and weight gradients against autodiff of an explicit gather;
    need_dw=False keeps the table gradient and zeroes the weight one."""
    tables, cols, ws = _inputs(jax.random.PRNGKey(1), C=4, Np=96)

    def loss(fn):
        return lambda t, w: jnp.sum(jnp.sin(fn(t, w)))

    got = jax.grad(loss(lambda t, w: mh.multihot_sample(
        t, cols, w, W_SEG, need_dw=need_dw)), argnums=(0, 1))(tables, ws)
    ref = jax.grad(loss(lambda t, w: _explicit(t, cols, w)),
                   argnums=(0, 1))(tables, ws)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=1e-5)
    if need_dw:
        np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                                   atol=1e-5)
    else:
        assert (np.asarray(got[1]) == 0).all()


def test_planes_dynamic_matches_reference_bilinear():
    """apply_dynamic (folded path) == explicit bilinear over (a, t)."""
    from nvsf_tpu.models.planes import (Planes4DSpec, _COO_COMBS, _DYNAMIC,
                                        bilinear_sample)

    spec = Planes4DSpec(output_dim=2, resolution=(8, 8, 8, 4),
                        multiscale_res=(1, 2))
    params = spec.init(jax.random.PRNGKey(0))
    params = [[p + 0.3 * jax.random.normal(jax.random.PRNGKey(i * 6 + j),
                                           p.shape)
               for j, p in enumerate(row)] for i, row in enumerate(params)]
    xt = jax.random.uniform(jax.random.PRNGKey(2), (33, 4))
    xt = xt.at[:, 3].set(xt[0, 3])  # scalar shared time

    got = spec.apply_dynamic(params, xt)
    refs = []
    for si in range(2):
        feat = None
        for ci in _DYNAMIC:
            a, b = _COO_COMBS[ci]
            H, W = spec.plane_hw(si, ci)
            f = bilinear_sample(params[si][ci].reshape(2, H, W),
                                xt[:, a], xt[:, b])
            feat = f if feat is None else feat * f
        refs.append(feat)
    ref = jnp.concatenate(refs, axis=-1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_planes_static_hybrid_matches_reference_bilinear():
    """apply_static (multihot coarse scales + gather fine scales) ==
    explicit bilinear product, across the multihot/gather boundary."""
    from nvsf_tpu.models.planes import (Planes4DSpec, _COO_COMBS, _STATIC,
                                        bilinear_sample)

    spec = Planes4DSpec(output_dim=2, resolution=(32, 32, 32, 4),
                        multiscale_res=(1, 2, 4, 8))
    assert spec.MULTIHOT_MAX_W == 4096  # scales 1,2 coarse; 4,8 fine
    params = spec.init(jax.random.PRNGKey(0))
    xt = jax.random.uniform(jax.random.PRNGKey(2), (40, 4))

    got = spec.apply_static(params, xt)
    refs = []
    for si in range(4):
        feat = None
        for ci in _STATIC:
            a, b = _COO_COMBS[ci]
            H, W = spec.plane_hw(si, ci)
            f = bilinear_sample(params[si][ci].reshape(2, H, W),
                                xt[:, a], xt[:, b])
            feat = f if feat is None else feat * f
        refs.append(feat)
    ref = jnp.concatenate(refs, axis=-1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
