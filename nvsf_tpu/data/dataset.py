"""Scene datasets: device-resident frame arrays + fixed-shape batch assembly.

Rebuilds ``nvsf/nerf/dataset/base_dataset.py`` device-first: instead of a torch
DataLoader whose collate samples rays on host every step
(``base_dataset.py:303-428``), all frames are preloaded once into device
arrays (the reference's ``preload`` path, ``base_dataset.py:262-290``) and
per-step ray sampling/gather happens inside the jitted train step.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from nvsf_tpu.lib import convert, pose as poselib, rays as raylib


@dataclass
class SceneData:
    """All frames of one sequence, as host numpy (moved to device lazily)."""
    # lidar
    poses_lidar: np.ndarray                 # [F, 4, 4] lidar2world (scaled)
    images_lidar: Optional[np.ndarray]      # [F, Hl, Wl, 3] (raydrop, intensity, depth*scale)
    H_lidar: int = 66
    W_lidar: int = 1030
    intrinsics_lidar: tuple = (2.0, 26.9)
    intrinsics_hoz_lidar: tuple = (180.0, 360.0)
    # camera
    poses: Optional[np.ndarray] = None      # [F, 4, 4] cam2world (scaled)
    images: Optional[np.ndarray] = None     # [F, H, W, 3]
    image_depths: Optional[np.ndarray] = None  # [F, H, W, 1] lidar pseudo-depth (m)
    H: int = 0
    W: int = 0
    intrinsics: Optional[np.ndarray] = None  # [3, 3]
    # temporal
    times: np.ndarray = None                # [F] in [0, 1]
    frame_ids: np.ndarray = None            # [F]
    num_frames: int = 0
    # annotations (list per frame of dicts with 'vertices' [8,3] world etc.)
    annotations: list = field(default_factory=list)
    split: str = "train"

    @property
    def has_gt(self) -> bool:
        return self.images_lidar is not None or self.images is not None

    def __len__(self):
        return len(self.poses_lidar) if self.poses_lidar is not None \
            else len(self.poses)


# ----------------------------------------------------------------------
# transforms-json loader (reference schema, ``base_dataset.py:60-157``)
# ----------------------------------------------------------------------

def load_scene(root_path: str, sequence_id: str, split: str, *,
               scale: float, offset, enable_lidar=True, enable_rgb=True,
               intrinsics_lidar=(2.0, 26.9),
               intrinsics_hoz_lidar=(180.0, 360.0),
               novel_sensor: Optional[dict] = None) -> SceneData:
    """Load ``transforms_{seq}_{split}.json`` + pano npys (+ images).

    ``novel_sensor`` (test-time only) carries the pose/intrinsics overrides of
    ``base_dataset.py:170-227``: keys delta_position, delta_orientation,
    H_lidar_new, W_lidar_new, intrinsics_lidar_new, intrinsics_hoz_lidar_new,
    delta_pos_camera, delta_orient_camera, H_new, W_new.
    """
    tpath = os.path.join(root_path, "train", str(sequence_id),
                         f"transforms_{sequence_id}_{split}.json")
    with open(tpath) as f:
        tf = json.load(f)

    H = int(tf.get("h", 0)) or None
    W = int(tf.get("w", 0)) or None
    H_lidar = int(tf["h_lidar"])
    W_lidar = int(tf["w_lidar"])
    num_frames = tf["num_frames"]
    frame_start, frame_end = tf["frame_start"], tf["frame_end"]
    frames = sorted(tf["frames"], key=lambda d: d["file_path"])

    fl_x = tf.get("fl_x", tf.get("fl_y"))
    fl_y = tf.get("fl_y", tf.get("fl_x"))
    cx = tf.get("cx", (W or 0) / 2)
    cy = tf.get("cy", (H or 0) / 2)
    K = np.array([[fl_x, 0, cx], [0, fl_y, cy], [0, 0, 1]], np.float64)

    poses, images, poses_lidar, images_lidar = [], [], [], []
    image_depths, times, frame_ids = [], [], []
    for f in frames:
        pose_lidar = np.array(f["lidar2world"], np.float32)
        pc = np.load(os.path.join(root_path, f["lidar_file_path"]))
        ray_drop = (pc[:, :, 2] != 0.0).astype(np.float32)[..., None]
        image_lidar = np.concatenate(
            [ray_drop, pc[:, :, 1:2], pc[:, :, 2:3] * scale], axis=-1)
        poses_lidar.append(pose_lidar)
        images_lidar.append(image_lidar)
        times.append((f["frame_id"] - frame_start)
                     / max(frame_end - frame_start, 1))
        frame_ids.append(f["frame_id"])

        if enable_rgb:
            import cv2
            pose = np.array(f["transform_matrix"], np.float32)
            img = cv2.imread(os.path.join(root_path, f["file_path"]),
                             cv2.IMREAD_UNCHANGED)
            img = cv2.cvtColor(
                img, cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4
                else cv2.COLOR_BGR2RGB)
            if H and (img.shape[0] != H or img.shape[1] != W):
                img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
            poses.append(pose)
            images.append(img.astype(np.float32) / 255.0)
            # lidar -> camera pseudo-depth (``base_dataset.py:152-157``)
            pts = convert.pano_to_lidar(pc[:, :, 2], intrinsics_lidar,
                                        intrinsics_hoz_lidar)
            pts2d = raylib.lidar_points_to_image_plane(
                pts, K, np.linalg.inv(pose.astype(np.float64)) @ pose_lidar)
            image_depths.append(raylib.lidar_depth_image(pts2d, (H, W)))

    poses_lidar = np.stack(poses_lidar)
    images_lidar = np.stack(images_lidar) if images_lidar else None
    poses = np.stack(poses) if poses else None
    images = np.stack(images) if images else None
    image_depths = np.stack(image_depths) if image_depths else None

    K_lidar = tuple(intrinsics_lidar)
    K_hoz = tuple(intrinsics_hoz_lidar)
    # novel-sensor overrides (``base_dataset.py:170-227``)
    if novel_sensor:
        ns = novel_sensor
        T = poselib.delta_transform(ns.get("delta_orientation", [0, 0, 0]),
                                    ns.get("delta_position", [0, 0, 0]))
        poses_lidar = (poses_lidar @ T).astype(np.float32)
        if ns.get("H_lidar_new"):
            H_lidar = int(ns["H_lidar_new"]) + 2  # 2 extra for extreme beams
        if ns.get("W_lidar_new"):
            W_lidar = int(ns["W_lidar_new"])
        if any(ns.get("intrinsics_lidar_new", [0, 0])):
            K_lidar = tuple(ns["intrinsics_lidar_new"])
        if any(ns.get("intrinsics_hoz_lidar_new", [0, 0])):
            K_hoz = tuple(ns["intrinsics_hoz_lidar_new"])
        if poses is not None:
            Tc = poselib.delta_transform(
                poselib.camera_delta_axes(ns.get("delta_orient_camera",
                                                 [0, 0, 0])),
                poselib.camera_delta_axes(ns.get("delta_pos_camera",
                                                 [0, 0, 0])))
            poses = (poses @ Tc).astype(np.float32)
            if ns.get("H_new") or ns.get("W_new"):
                sx = ns.get("W_new", 0) / W if ns.get("W_new") else 1
                sy = ns.get("H_new", 0) / H if ns.get("H_new") else 1
                K[0, 2] *= sx
                K[1, 2] *= sy
                H = ns.get("H_new") or H
                W = ns.get("W_new") or W
        # GT invalid after overrides
        images_lidar = images = image_depths = None

    poses_lidar = poselib.recenter_and_scale_poses(poses_lidar, offset, scale)
    if poses is not None:
        poses = poselib.recenter_and_scale_poses(poses, offset, scale)

    return SceneData(
        poses_lidar=poses_lidar, images_lidar=images_lidar,
        H_lidar=H_lidar, W_lidar=W_lidar,
        intrinsics_lidar=K_lidar, intrinsics_hoz_lidar=K_hoz,
        poses=poses, images=images, image_depths=image_depths,
        H=H or 0, W=W or 0, intrinsics=K,
        times=np.asarray(times, np.float32),
        frame_ids=np.asarray(frame_ids, np.float32),
        num_frames=num_frames, split=split)
