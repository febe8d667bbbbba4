"""Observability: console+file logger, tensorboard scalars, sampling-heatmap
dumps, model summaries.

Rebuilds the reference's logging surface (``nvsf/nerf/utils.py:497-557``:
rich console + append-file logger; ``trainer.py:1364-1368,1793-1841``:
tensorboardX scalars; ``utils.py:875-920``: training-sampling heatmaps;
``utils.py:521-526``: parameter counts).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np


class Logger:
    """Console + append-file logger (``utils.py:510-557``)."""

    def __init__(self, workspace: Optional[str] = None,
                 name: str = "nvsf", quiet: bool = False):
        self.quiet = quiet
        self.fp = None
        if workspace:
            os.makedirs(workspace, exist_ok=True)
            self.path = os.path.join(workspace, f"log_{name}.txt")
            self.fp = open(self.path, "a")

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        if not self.quiet:
            print(msg, flush=True)
        if self.fp:
            self.fp.write(f"[{stamp}] {msg}\n")
            self.fp.flush()

    __call__ = log

    def close(self):
        if self.fp:
            self.fp.close()
            self.fp = None


class TensorboardWriter:
    """Thin tensorboardX wrapper; silently disabled if unavailable."""

    def __init__(self, workspace: str, name: str = "run"):
        try:
            import tensorboardX
            self.writer = tensorboardX.SummaryWriter(
                os.path.join(workspace, name))
        except Exception:
            self.writer = None

    def add_scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def add_scalars_dict(self, prefix, values: dict, step):
        for k, v in values.items():
            try:
                self.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass  # vector-valued metrics are written by their meters

    def close(self):
        if self.writer is not None:
            self.writer.close()


def save_sampling_heatmap(error_map: np.ndarray, path: str,
                          title: str = "") -> None:
    """Dump a per-frame sampling-weight heatmap PNG
    (``utils.py:875-920`` analogue; the error map IS the sampling law)."""
    from nvsf_tpu.lib.tools import write_png
    em = np.asarray(error_map, np.float64)
    em = em / max(em.max(), 1e-12)
    img = (np.sqrt(em) * 255).astype(np.uint8)  # sqrt for visibility
    write_png(path, img)


def count_parameters(params) -> int:
    import jax
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(params))


def model_summary(params) -> str:
    """Per-module parameter counts (``utils.py:521-526`` analogue)."""
    import jax
    lines = []
    total = 0
    for k, v in params.items():
        n = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(v))
        total += n
        lines.append(f"  {k:20s} {n:>12,d}")
    lines.append(f"  {'TOTAL':20s} {total:>12,d}")
    return "\n".join(lines)
