"""Metric meter tests: golden values and protocol behavior."""

import json

import numpy as np
import pytest

from nvsf_tpu.lib import metrics as M

pytest.importorskip("scipy")


def test_psnr_meter_golden():
    m = M.PSNRMeter()
    p = np.zeros((1, 10, 10, 3))
    t = np.full((1, 10, 10, 3), 0.1)
    m.update(p, t)
    np.testing.assert_allclose(m.measure(), -10 * np.log10(0.01 + 1e-8),
                               rtol=1e-6)


def test_rmse_meter_rgb_depth_mask():
    m = M.RMSEMeter(rgb_metric=True)
    t = np.array([[0.0, 10.0, 100.0]])
    p = np.array([[5.0, 12.0, 100.0]])
    # zero-mask kills pred where gt == 0; clip at 80
    m.update(p, t)
    np.testing.assert_allclose(m.measure(),
                               np.sqrt((0 + 4 + (80 - 80) ** 2) / 3),
                               rtol=1e-6)


def test_raydrop_meter():
    m = M.RaydropMeter(ratio=0.5)
    t = np.array([1, 1, 0, 0, 1], np.float32)
    p = np.array([0.9, 0.2, 0.1, 0.8, 0.7], np.float32)
    m.update(p, t)
    rmse, acc, f1 = m.measure()
    assert acc == 3 / 5
    prec, rec = 2 / 3, 2 / 3
    np.testing.assert_allclose(f1, 2 * prec * rec / (prec + rec), rtol=1e-6)


def test_points_meter_identical_is_zero_cd():
    pano = np.zeros((16, 64))
    pano[8, 10] = 10.0
    pano[4, 50] = 25.0
    m = M.PointsMeter(scale=1.0, intrinsics=(2.0, 26.9),
                      intrinsics_hoz=(180.0, 360.0))
    m.update(pano, pano)
    cd, f = m.measure()
    assert cd < 1e-4
    assert f == 1.0


def test_ssim_skimage_matches_known_cases():
    a = np.random.default_rng(0).uniform(size=(32, 32))
    assert abs(M.ssim_skimage(a, a, data_range=1.0) - 1.0) < 1e-9
    b = 1.0 - a
    assert M.ssim_skimage(a, b, data_range=1.0) < 0.2


def test_ssim_gaussian_range():
    a = np.random.default_rng(1).uniform(size=(24, 24, 3))
    assert abs(M.ssim_gaussian(a, a) - 1.0) < 1e-9
    n = np.clip(a + np.random.default_rng(2).normal(0, 0.2, a.shape), 0, 1)
    v = M.ssim_gaussian(a, n)
    assert 0.0 < v < 0.9


def test_l4d_depth_meter_shape():
    m = M.DepthMeter_L4D(scale=0.01)
    t = np.abs(np.random.default_rng(0).normal(0.3, 0.1, (32, 64))) * 0.01
    p = t + 0.001
    m.update(p[None], t[None])
    vals = m.measure()
    assert vals.shape == (5,)
    rmse, medae, lp, ssim, psnr = vals
    np.testing.assert_allclose(rmse, 0.1, rtol=1e-4)  # 0.001/0.01 m error
    assert np.isnan(lp)  # LPIPS gated without weights
    assert 0 < ssim <= 1
    assert psnr > 20


def test_lpips_gated():
    m = M.LPIPSMeter()
    assert not m.available
    m.update(np.zeros((8, 8, 3)), np.ones((8, 8, 3)))
    assert np.isnan(m.measure())


def test_write_error_matrix(tmp_path):
    meters = {"psnr": M.PSNRMeter(), "raydrop": M.RaydropMeter()}
    meters["psnr"].update(np.zeros((4, 4)), np.full((4, 4), 0.5))
    meters["raydrop"].update(np.array([0.9, 0.1]), np.array([1.0, 0.0]))
    out = str(tmp_path / "err.json")
    res = M.write_error_matrix(meters, out, extra={"epoch": 3})
    loaded = json.loads(open(out).read())
    assert loaded["epoch"] == 3
    assert "psnr" in loaded and "raydrop" in loaded
    assert res["psnr"] == pytest.approx(meters["psnr"].measure())


def test_lpips_numerical_vs_numpy_reference(tmp_path):
    """Synthetic-weights parity for the LPIPS conv pipeline (random npz through the documented export schema, compared
    against an independent hand-rolled numpy forward. Only the real
    weights FILE — not the code — remains unvalidated in this env."""
    import numpy as np
    from nvsf_tpu.lib import lpips_jax as L

    rng = np.random.default_rng(0)
    # small AlexNet-shaped net: 5 conv stages, tiny channels/kernels
    chans = [3, 4, 5, 6, 6, 4]
    ksz = [5, 3, 3, 3, 3]
    w = {}
    for i in range(5):
        w[f"conv{i}_w"] = rng.normal(
            0, 0.3, (chans[i + 1], chans[i], ksz[i], ksz[i])).astype(
                np.float32)
        w[f"conv{i}_b"] = rng.normal(0, 0.1, (chans[i + 1],)).astype(
            np.float32)
        w[f"lin{i}_w"] = rng.uniform(
            0, 1, (1, chans[i + 1], 1, 1)).astype(np.float32)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **w)

    H = W = 20
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)

    got = L.lpips_from_file(path, a, b)

    # ---- independent numpy forward ----
    def conv2d(x, k, bias, stride, pad):
        C_out, C_in, kh, kw = k.shape
        _, H0, W0 = x.shape
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
        Ho = (H0 + 2 * pad - kh) // stride + 1
        Wo = (W0 + 2 * pad - kw) // stride + 1
        out = np.zeros((C_out, Ho, Wo), np.float32)
        for oy in range(Ho):
            for ox in range(Wo):
                patch = xp[:, oy * stride:oy * stride + kh,
                           ox * stride:ox * stride + kw]
                out[:, oy, ox] = np.tensordot(k, patch, axes=3) + bias
        return out

    def maxpool(x, k=3, s=2):
        C, H0, W0 = x.shape
        Ho = (H0 - k) // s + 1
        Wo = (W0 - k) // s + 1
        out = np.zeros((C, Ho, Wo), np.float32)
        for oy in range(Ho):
            for ox in range(Wo):
                out[:, oy, ox] = x[:, oy * s:oy * s + k,
                                   ox * s:ox * s + k].max(axis=(1, 2))
        return out

    def feats(img):
        x = img.transpose(2, 0, 1) * 2.0 - 1.0        # [3, H, W] in [-1,1]
        x = (x - L._SHIFT[:, None, None]) / L._SCALE[:, None, None]
        out = []
        for i in range(5):
            x = conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"],
                       L._ALEX_STRIDES[i], L._ALEX_PADS[i])
            x = np.maximum(x, 0.0)
            out.append(x)
            if L._POOL_AFTER[i]:
                x = maxpool(x)
        return out

    fa, fb = feats(a), feats(b)
    want = 0.0
    for i, (xa, xb) in enumerate(zip(fa, fb)):
        na = xa / np.sqrt((xa ** 2).sum(axis=0, keepdims=True) + 1e-10)
        nb = xb / np.sqrt((xb ** 2).sum(axis=0, keepdims=True) + 1e-10)
        d = (na - nb) ** 2
        lin = w[f"lin{i}_w"][0, :, 0, 0]
        want += (lin[:, None, None] * d).sum(axis=0).mean()

    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
