"""Failure-recovery tests: epoch loop rides through injected device errors."""

import numpy as np
import pytest

from nvsf_tpu.data.synthetic import make_synthetic_scene
from nvsf_tpu.train.resilience import is_recoverable, run_epochs_with_recovery
from nvsf_tpu.train.trainer import Trainer

from test_trainer import SCENE_SPEC, tiny_config


def test_is_recoverable_classification():
    assert is_recoverable(RuntimeError("UNAVAILABLE: GPU worker crashed"))
    assert is_recoverable(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not is_recoverable(ValueError("shape mismatch"))


@pytest.mark.slow
def test_recovery_resumes_from_checkpoint(tmp_path):
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    tr = Trainer(tiny_config(change_patch_size_lidar=[1]), scene,
                 workspace=str(tmp_path))

    fail_at = {3}
    orig = tr.train_one_epoch

    def flaky(*a, **k):
        if tr.epoch in fail_at:
            fail_at.clear()
            raise RuntimeError("UNAVAILABLE: GPU worker crashed or restarted")
        return orig(*a, **k)

    tr.train_one_epoch = flaky
    seen = []

    def on_epoch(ep, stats):
        seen.append(ep)
        tr.save_checkpoint(full=True)

    run_epochs_with_recovery(tr, 1, 5, on_epoch, max_restarts=2,
                             backoff_s=0.01, log_fn=None)
    assert 5 in seen and len(seen) >= 5


def test_recovery_gives_up_on_logic_errors(tmp_path):
    scene = make_synthetic_scene(SCENE_SPEC, split="train")
    tr = Trainer(tiny_config(change_patch_size_lidar=[1]), scene,
                 workspace=str(tmp_path))
    tr.train_one_epoch = lambda *a, **k: (_ for _ in ()).throw(
        ValueError("bug"))
    with pytest.raises(ValueError):
        run_epochs_with_recovery(tr, 1, 2, lambda e, s: None,
                                 backoff_s=0.01, log_fn=None)
