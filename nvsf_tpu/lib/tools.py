"""Misc IO / geometry helpers (rebuilds ``nvsf/lib/tools.py``)."""

from __future__ import annotations

import csv
import json
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np

from nvsf_tpu.lib.pose import bbox_corners, quaternion_to_matrix  # re-export


def read_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(path, data):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=float)


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def write_csv(path, rows):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


def read_yaml(path):
    """Minimal yaml reader (flat key: value maps) — PyYAML is not baked into
    this image; full yaml configs should use json/txt instead."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = v.strip()
    return out


def dict_to_cls(**kwargs):
    """dict -> attribute object (``tools.py:162-165``)."""
    return SimpleNamespace(**{
        k: (dict_to_cls(**v) if isinstance(v, dict) else v)
        for k, v in kwargs.items()})


def check_in_hull(points, hull_vertices):
    """Convex-hull membership (``tools.py:138-160``); see lib/masks.py."""
    from nvsf_tpu.lib.masks import check_in_hull as _cih
    return _cih(np.asarray(points), np.asarray(hull_vertices))


def filter_outliers(pc, nb_neighbors=20, std_ratio=2.0):
    """Statistical outlier filter (``tools.py:84-115``)."""
    from nvsf_tpu.lib.pointcloud import statistical_outlier_removal
    return statistical_outlier_removal(np.asarray(pc), nb_neighbors,
                                       std_ratio)


def write_pcd(path, points, intensities=None):
    """ASCII .pcd writer (replaces the open3d writer, ``tools.py:230-249``)."""
    pts = np.asarray(points)
    n = len(pts)
    has_i = intensities is not None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        fields = "x y z intensity" if has_i else "x y z"
        nf = 4 if has_i else 3
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        f.write(f"SIZE {' '.join(['4'] * nf)}\n")
        f.write(f"TYPE {' '.join(['F'] * nf)}\n")
        f.write(f"COUNT {' '.join(['1'] * nf)}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        inten = np.asarray(intensities).reshape(-1) if has_i else None
        for i in range(n):
            row = f"{pts[i, 0]:.6f} {pts[i, 1]:.6f} {pts[i, 2]:.6f}"
            if has_i:
                row += f" {inten[i]:.6f}"
            f.write(row + "\n")


def write_png(path, img):
    """Write an 8-bit grayscale [H, W] or RGB/RGBA [H, W, 3|4] image as PNG
    with the standard library alone (zlib + struct)."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    color = {2: 0, 3: {3: 2, 4: 6}.get(a.shape[-1])}.get(a.ndim)
    if color is None:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3|4], got "
                         f"{a.shape}")
    h, w = a.shape[:2]
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
