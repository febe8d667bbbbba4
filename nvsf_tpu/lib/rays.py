"""Ray generation for LiDAR panos and pinhole cameras (pure jnp, jit-safe).

Rebuilds ``nvsf/nerf/dataset/dataset_utils.py:369-687`` device-first: direction
math is a pure function of flat pixel indices so the whole sampling + gather
path fuses into the jitted train step (the reference runs this per-batch on
host inside the DataLoader collate).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def lidar_directions_from_indices(inds, H, W, intrinsics_lidar, intrinsics_hoz_lidar):
    """Flat pano pixel indices [N] -> local ray directions [N, 3].

    Angle convention matches ``dataset_utils.py:512-526``:
      beta  = -(i - W/2) / W * fov_hoz  (azimuth, degrees -> radians)
      alpha = (fov_up - j/H * fov)      (inclination)
    with i = col, j = row.
    """
    fov_up, fov = intrinsics_lidar
    _fov_hoz_up, fov_hoz = intrinsics_hoz_lidar
    j = (inds // W).astype(jnp.float32)  # row
    i = (inds % W).astype(jnp.float32)   # col
    beta = -(i - W / 2) / W * fov_hoz / 180 * jnp.pi
    alpha = (fov_up - j / H * fov) / 180 * jnp.pi
    return jnp.stack(
        [jnp.cos(alpha) * jnp.cos(beta),
         jnp.cos(alpha) * jnp.sin(beta),
         jnp.sin(alpha)], axis=-1)


def camera_directions_from_indices(inds, H, W, intrinsics):
    """Flat image pixel indices [N] -> normalized local ray dirs [N, 3].

    Pinhole model with +0.5 pixel-center offset (``dataset_utils.py:563-677``).
    ``intrinsics`` is the 3x3 K matrix.
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    j = (inds // W).astype(jnp.float32) + 0.5
    i = (inds % W).astype(jnp.float32) + 0.5
    zs = jnp.ones_like(i)
    xs = (i - cx) / fx * zs
    ys = (j - cy) / fy * zs
    d = jnp.stack([xs, ys, zs], axis=-1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def rays_from_pose(pose, directions):
    """Rotate local dirs into world and broadcast origins.

    pose: [4, 4] sensor2world;  directions: [N, 3] local.
    Returns (rays_o [N, 3], rays_d [N, 3]) — ``dataset_utils.py:528-530``.

    The 3x3 rotation is written out as elementwise products: as a matmul
    the GPU would run it in TF32 (~1e-3 relative), moving samples at 80 m
    by centimetres.
    """
    rays_d = sum(directions[:, k:k + 1] * pose[:3, k] for k in range(3))
    rays_o = jnp.broadcast_to(pose[:3, 3], rays_d.shape)
    return rays_o, rays_d


def get_lidar_rays(pose, inds, H, W, intrinsics_lidar, intrinsics_hoz_lidar):
    dirs = lidar_directions_from_indices(inds, H, W, intrinsics_lidar,
                                         intrinsics_hoz_lidar)
    return rays_from_pose(pose, dirs)


def get_camera_rays(pose, inds, H, W, intrinsics):
    dirs = camera_directions_from_indices(inds, H, W, intrinsics)
    return rays_from_pose(pose, dirs)


def all_indices(H: int, W: int) -> jnp.ndarray:
    return jnp.arange(H * W, dtype=jnp.int32)


# ----------------------------------------------------------------------
# host-side helpers for pseudo-depth supervision (``dataset_utils.py:17-138``)
# ----------------------------------------------------------------------

def lidar_points_to_image_plane(points_lidar: np.ndarray, K: np.ndarray,
                                cam2lidar_inv: np.ndarray) -> np.ndarray:
    """Project (N,3) lidar-frame points into pixel coords (N,3): [u, v, depth].

    ``cam2lidar_inv`` is inv(cam2world) @ lidar2world, i.e. lidar->camera.
    Mirrors ``dataset_utils.lidar2points2d`` (``dataset_utils.py:17-32``).
    """
    N = points_lidar.shape[0]
    pts_h = np.concatenate([points_lidar, np.ones((N, 1))], axis=1)
    cam_pts = (cam2lidar_inv @ pts_h.T).T[:, :3]
    z = cam_pts[:, 2]
    uv = (K @ cam_pts.T).T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uv / uv[:, 2:3]
    return np.concatenate([uv[:, :2], z[:, None]], axis=1)


def lidar_depth_image(pts_2d: np.ndarray, img_shape) -> np.ndarray:
    """Splat projected points to a sparse (H, W, 1) depth image, closest wins
    (``dataset_utils.get_lidar_depth_image``, ``dataset_utils.py:69-96``)."""
    H, W = img_shape
    u = np.rint(pts_2d[:, 0]).astype(np.int64)
    v = np.rint(pts_2d[:, 1]).astype(np.int64)
    z = pts_2d[:, 2]
    valid = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z = u[valid], v[valid], z[valid]
    order = np.argsort(-z, kind="stable")
    depth = np.zeros((H, W), dtype=np.float32)
    depth[v[order], u[order]] = z[order]
    return depth[..., None]
