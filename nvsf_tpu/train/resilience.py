"""Failure detection + recovery: retry training epochs across device/runtime
failures by reloading the latest checkpoint.

The reference's only fault tolerance is NaN scrubbing + manual checkpoint
resume (SURVEY §5). Accelerators can be lost mid-run (preemption, resets),
so the trainer here can ride through: on a runtime error the device state is
rebuilt from the last full checkpoint and the epoch loop continues.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax

# error types that indicate a lost/na device rather than a bug
_RECOVERABLE_MARKERS = (
    "UNAVAILABLE", "RESOURCE_EXHAUSTED", "ABORTED", "INTERNAL",
    "crashed or restarted", "DATA_LOSS",
)


def is_recoverable(err: Exception) -> bool:
    msg = f"{type(err).__name__}: {err}"
    return any(m in msg for m in _RECOVERABLE_MARKERS)


def run_epochs_with_recovery(trainer, first_epoch: int, last_epoch: int,
                             on_epoch: Callable[[int, object], None],
                             max_restarts: int = 3,
                             backoff_s: float = 30.0, log_fn=print):
    """Run trainer epochs [first, last], restarting from the latest
    checkpoint on recoverable device failures.

    on_epoch(epoch, stats) runs after each epoch (eval/checkpoint hooks).
    """
    restarts = 0
    ep = first_epoch
    while ep <= last_epoch:
        try:
            trainer.epoch = ep
            stats = trainer.train_one_epoch()
            on_epoch(ep, stats)
            ep += 1
        except Exception as err:  # noqa: BLE001 — classified below
            if not is_recoverable(err) or restarts >= max_restarts:
                raise
            restarts += 1
            if log_fn:
                log_fn(f"[recovery] epoch {ep} failed "
                       f"({type(err).__name__}); restart "
                       f"{restarts}/{max_restarts} in {backoff_s:.0f}s")
            time.sleep(backoff_s)
            # drop device buffers, then restore from the last checkpoint
            jax.clear_caches()
            if trainer.load_checkpoint("latest"):
                ep = trainer.epoch + 1  # resume after the checkpointed epoch
                if log_fn:
                    log_fn(f"[recovery] restored checkpoint at epoch "
                           f"{trainer.epoch}; resuming from {ep}")
            elif log_fn:
                log_fn("[recovery] no checkpoint found; retrying epoch "
                       f"{ep} with in-memory state")
    return trainer
