"""Loss functions (all elementwise, reduction='none' semantics).

Mirrors the criterion construction of ``main_nvsf.py:204-222`` and the loss
terms assembled in ``trainer.py:153-547``: LiDAR depth/intensity/raydrop,
chamfer self-supervision, scene-flow consistency, URF line-of-sight, patch
structural regularizers, camera RGB and RGB-D.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

from nvsf_tpu.ops.chamfer import chamfer_distance, chamfer_loss


# ----------------------------------------------------------------------
# elementwise criteria (torch.nn losses with reduction='none')
# ----------------------------------------------------------------------

def mse(pred, gt):
    return (pred - gt) ** 2


def l1(pred, gt):
    return jnp.abs(pred - gt)


def smooth_l1(pred, gt, beta: float = 0.1):
    d = jnp.abs(pred - gt)
    return jnp.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def huber(pred, gt, delta: float = 1.0):
    d = jnp.abs(pred - gt)
    return jnp.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def bce_with_logits(pred, gt):
    return jnp.maximum(pred, 0) - pred * gt + jnp.log1p(jnp.exp(-jnp.abs(pred)))


def cosine_similarity(pred, gt, axis=-1, eps=1e-8):
    num = jnp.sum(pred * gt, axis=axis)
    den = jnp.linalg.norm(pred, axis=axis) * jnp.linalg.norm(gt, axis=axis)
    return num / jnp.maximum(den, eps)


def make_criterion(name: str, scale: float = 1.0) -> Callable:
    """Criterion factory matching ``main_nvsf.py:205-212`` (huber delta is
    0.2 * scene scale)."""
    table = {
        "mse": mse,
        "l1": l1,
        "smoothl1": lambda p, g: smooth_l1(p, g, 0.1),
        "huber": lambda p, g: huber(p, g, 0.2 * scale),
        "bce": bce_with_logits,
        "cos": cosine_similarity,
    }
    return table[name]


# ----------------------------------------------------------------------
# composite losses
# ----------------------------------------------------------------------

def lidar_losses(pred_raydrop, pred_intensity, pred_depth,
                 gt_raydrop, gt_intensity, gt_depth, criterion: Dict,
                 alpha_d=1.0, alpha_i=0.1, alpha_r=0.01, smooth_factor=0.0):
    """Depth / intensity / ray-drop terms (``trainer.py:186-219``).

    All preds/gts are [N]; intensity & depth are already masked by
    gt_raydrop by the caller. Returns (per-ray loss [N], parts dict).
    """
    gt_raydrop_s = jnp.clip(gt_raydrop, smooth_factor, 1.0 - smooth_factor)
    # pred_raydrop arrives ready for the criterion: the trainer applies the
    # sigmoid for the bce path BEFORE calling here (``trainer.py:435-436``
    # in this repo, mirroring the reference's pre-loss sigmoid at
    # ``nvsf/nerf/trainer.py:208-209``) — no branching needed at this level
    loss_rd = alpha_r * criterion["raydrop"](pred_raydrop, gt_raydrop_s)
    loss_d = alpha_d * criterion["depth"](pred_depth, gt_depth)
    loss_i = alpha_i * criterion["intensity"](pred_intensity, gt_intensity)
    total = loss_d + loss_rd + loss_i
    return total, {"loss_d": loss_d.sum(), "loss_i": loss_i.sum(),
                   "loss_rd": loss_rd.sum()}


def lidar_chamfer_loss(rays_d, pred_depth, gt_depth, scale):
    """Self-supervised CD between predicted and GT point clouds
    (``trainer.py:229-233``)."""
    pred_pts = rays_d * (pred_depth / scale)[:, None]
    gt_pts = rays_d * (gt_depth / scale)[:, None]
    d1, d2 = chamfer_distance(pred_pts, gt_pts)
    return 0.5 * (d1 + d2).mean()


def flow_consistency_loss(pc, pc_mask, pc_next, pc_next_mask, flow):
    """One direction of the scene-flow loss (``trainer.py:247-267``):
    chamfer(pc + flow, pc_next) summed + L1 flow magnitude."""
    pc_pred = pc + flow
    d1, d2 = chamfer_distance(pc_pred, pc_next, a_mask=pc_mask,
                              b_mask=pc_next_mask)
    cd = 0.5 * (d1.sum() + d2.sum())
    n_valid = jnp.maximum(pc_mask.sum(), 1)
    mag = jnp.where(pc_mask[:, None], jnp.abs(flow), 0.0).sum() / (n_valid * 3)
    return cd + mag


def urf_line_of_sight_loss(weights, z_vals, gt_depth, global_step, iters):
    """Urban-Radiance-Fields line-of-sight loss (``trainer.py:276-294``):
    eps-shrinking empty-space suppression + gaussian near-surface matching."""
    eps = 0.02 * 0.1 ** jnp.minimum(global_step / iters, 1.0)
    gt = gt_depth[:, None]                     # [N, 1]
    depth_mask = gt > 0.0
    mask_empty = (z_vals < gt - eps) | (z_vals > gt + eps)
    denom = jnp.maximum(depth_mask.sum(), 1)
    loss_empty = ((mask_empty * weights) ** 2).sum() / denom

    mask_near = (z_vals > gt - eps) & (z_vals < gt + eps)
    distance = mask_near * (z_vals - gt)
    sigma_g = eps / 3.0
    distr = jnp.exp(-(distance ** 2) / (2 * sigma_g ** 2)) \
        / (sigma_g * jnp.sqrt(2 * jnp.pi))
    distr = distr / jnp.maximum(distr.max(), 1e-12)
    distr = distr * mask_near
    loss_near = ((mask_near * weights - distr) ** 2).sum() / denom
    return 0.1 * loss_empty + 0.1 * loss_near


# ----------------------------------------------------------------------
# patch structural regularizers (``trainer.py:296-462``)
# ----------------------------------------------------------------------

_SOBEL_X = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], jnp.float32)
_SOBEL_Y = jnp.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], jnp.float32)


def _conv2d_same(x, k):
    """x: [B, H, W]; k: [3, 3] -> same-padded conv."""
    return jax.lax.conv_general_dilated(
        x[:, None], k[None, None], (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0]


def patch_gradients(depth_patches, sobel=False):
    """x/y gradients of [B, H, W] patches; manual diffs pad-replicate the last
    row/col (``trainer.py:316-334``)."""
    if sobel:
        return _conv2d_same(depth_patches, _SOBEL_X), \
            _conv2d_same(depth_patches, _SOBEL_Y)
    gx = depth_patches[:, :, :-1] - depth_patches[:, :, 1:]
    gx = jnp.concatenate([gx, gx[:, :, -1:]], axis=2)
    gy = depth_patches[:, :-1, :] - depth_patches[:, 1:, :]
    gy = jnp.concatenate([gy, gy[:, -1:, :]], axis=1)
    return gx, gy


def pano_double_gradients(pano_depth, scale):
    """|d/dx|, |d/dy| second differences of the full GT pano, used to mask the
    gradient loss to smooth regions (``trainer.py:398-411``)."""
    d = pano_depth / scale
    gx = d[:, :-1] - d[:, 1:]
    gx = jnp.concatenate([gx, gx[:, -1:]], axis=1)
    gy = d[:-1, :] - d[1:, :]
    gy = jnp.concatenate([gy, gy[-1:, :]], axis=0)
    gxx = jnp.abs(gx[:, :-1]) - jnp.abs(gx[:, 1:])
    gxx = jnp.concatenate([gxx, gxx[:, -1:]], axis=1)
    gyy = jnp.abs(gy[:-1, :]) - jnp.abs(gy[1:, :])
    gyy = jnp.concatenate([gyy, gyy[-1:, :]], axis=0)
    return gxx, gyy


def structural_regularizers(pred_depth_patches, gt_depth_patches,
                            gt_raydrop_patches, grad_mask_x, grad_mask_y,
                            criterion_grad, cfg_flags):
    """Edge-aware / smoothness / TV / gradient-matching terms on patch-shaped
    depth (``trainer.py:296-462``). All inputs [B, ph, pw] in metric units.

    cfg_flags: dict with keys grad_norm_smooth, spatial_smooth, tv_loss,
    grad_loss, sobel_grad, depth_grad_loss_is_cos, alpha_* weights.
    """
    sobel = cfg_flags.get("sobel_grad", False)
    gx, gy = patch_gradients(pred_depth_patches, sobel)
    loss = 0.0
    if cfg_flags.get("grad_norm_smooth"):
        loss = loss + cfg_flags["alpha_grad_norm"] * (
            jnp.exp(-jnp.abs(gx)) + jnp.exp(-jnp.abs(gy))).sum()
    if cfg_flags.get("spatial_smooth"):
        loss = loss + cfg_flags["alpha_spatial"] * (gx ** 2 + gy ** 2).sum()
    if cfg_flags.get("tv_loss"):
        loss = loss + cfg_flags["alpha_tv"] * (
            jnp.abs(gx) + jnp.abs(gy)).sum()
    if cfg_flags.get("grad_loss"):
        ggx, ggy = patch_gradients(gt_depth_patches, sobel)
        mask_dx = gt_raydrop_patches * grad_mask_x
        mask_dy = gt_raydrop_patches * grad_mask_y
        B = pred_depth_patches.shape[0]
        if cfg_flags.get("depth_grad_loss_is_cos"):
            cx = criterion_grad((gx * mask_dx).reshape(B, -1),
                                (ggx * mask_dx).reshape(B, -1))
            cy = criterion_grad((gy * mask_dy).reshape(B, -1),
                                (ggy * mask_dy).reshape(B, -1))
            ph, pw = pred_depth_patches.shape[1:]
            gl = ((1 - cx)[:, None, None] + (1 - cy)[:, None, None]) \
                * jnp.ones((1, ph, pw))
        else:
            gl = criterion_grad(gx * mask_dx, ggx * mask_dx) \
                + criterion_grad(gy * mask_dy, ggy * mask_dy)
        loss = loss + cfg_flags["alpha_grad"] * gl.sum()
    return loss


def mape_loss(pred, gt, eps=1e-2):
    """Mean-absolute-percentage style loss (``nvsf/nerf/loss.py`` inventory;
    unused by the reference trainer but part of its loss library)."""
    return jnp.abs(pred - gt) / (jnp.abs(gt) + eps)


def eff_distortion_loss(weights, z_vals):
    """O(N) mip-NeRF-360 distortion loss (the reference ships ``EffDistLoss``
    in ``nvsf/nerf/loss.py:29-87``, also unused by its trainer).

    weights: [N, T]; z_vals: [N, T] (interval midpoints).
    L = sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 d_i, computed in O(T)
    via prefix sums.
    """
    m = z_vals
    w = weights
    wm = w * m
    cw = jnp.cumsum(w, axis=-1) - w
    cwm = jnp.cumsum(wm, axis=-1) - wm
    cross = 2.0 * jnp.sum(wm * cw - w * cwm, axis=-1)
    d = jnp.concatenate([m[..., 1:] - m[..., :-1],
                         jnp.zeros_like(m[..., :1])], axis=-1)
    self_term = jnp.sum(w * w * d, axis=-1) / 3.0
    return cross + self_term


def scrub_loss(loss):
    """NaN -> 0, Inf -> 1e5 (``trainer.py:549-550``)."""
    loss = jnp.where(jnp.isnan(loss), 0.0, loss)
    return jnp.where(jnp.isinf(loss), 1e5, loss)
