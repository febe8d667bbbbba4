"""U-Net + refine stage tests."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from nvsf_tpu.models.unet import UNetSpec
from nvsf_tpu.train.refine import (onecycle_lr, random_box_mask,
                                   refine_raydrop, apply_refinement)

SPEC = UNetSpec(in_channels=3, channels=8, out_channels=1)


def test_unet_shapes_and_range():
    params, stats = SPEC.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 3, 32, 64))
    out, new_stats = jax.jit(
        lambda p, s, xx: SPEC.apply(p, s, xx, train=False))(params, stats, x)
    assert out.shape == (2, 1, 32, 64)
    assert bool(jnp.all((out >= 0) & (out <= 1)))


def test_unet_odd_sizes_pad():
    params, stats = SPEC.init(jax.random.PRNGKey(0))
    # 66x1030-like odd dims exercise the skip-connection padding
    x = jax.random.uniform(jax.random.PRNGKey(1), (1, 3, 34, 70))
    out, _ = SPEC.apply(params, stats, x, train=False)
    assert out.shape == (1, 1, 34, 70)


def test_unet_train_mode_updates_stats():
    params, stats = SPEC.init(jax.random.PRNGKey(0))
    x = jax.random.uniform(jax.random.PRNGKey(1), (1, 3, 16, 16)) + 3.0
    _, new_stats = SPEC.apply(params, stats, x, train=True,
                              key=jax.random.PRNGKey(2))
    before = float(stats["down1"]["bn1"]["mean"].sum())
    after = float(new_stats["down1"]["bn1"]["mean"].sum())
    assert after != before


def test_onecycle_shape():
    s = onecycle_lr(1e-3, 100)
    lrs = [float(s(i)) for i in [0, 15, 30, 65, 99]]
    assert lrs[0] < lrs[2]          # warmup rises to peak at pct_start
    assert abs(lrs[2] - 1e-3) < 1e-9
    assert lrs[4] < lrs[3] < lrs[2]  # anneal


def test_random_box_mask():
    m = random_box_mask(jax.random.PRNGKey(3), (2, 3, 40, 60))
    m = np.asarray(m)
    assert m.shape == (2, 3, 40, 60)
    assert set(np.unique(m)).issubset({0.0, 1.0})
    assert m.mean() > 0.5  # boxes cover a minority of the image


@pytest.mark.slow  # fast tier covers this via the recovery/CLI tests
def test_refine_learns_identity_raydrop():
    """The U-Net must learn to reproduce a simple GT raydrop pattern from a
    noisy prediction in a few hundred steps."""
    rng = np.random.default_rng(0)
    H, W = 32, 64
    gt = np.zeros((2, 1, H, W), np.float32)
    gt[:, :, :, : W // 2] = 1.0
    noisy = np.clip(gt + rng.normal(0, 0.3, gt.shape), 0, 1)
    x = np.concatenate([noisy,
                        rng.uniform(size=(2, 1, H, W)).astype(np.float32),
                        rng.uniform(size=(2, 1, H, W)).astype(np.float32)],
                       axis=1)
    params, stats = SPEC.init(jax.random.PRNGKey(0))
    params, stats, losses = refine_raydrop(SPEC, params, stats, x, gt,
                                           steps=150, lr=3e-3)
    assert losses[-1] < losses[0]
    refined = apply_refinement(SPEC, params, stats, x[0, 0], x[0, 1],
                               x[0, 2])
    acc = ((np.asarray(refined) > 0.5) == (gt[0, 0] > 0.5)).mean()
    assert acc > 0.9, acc
