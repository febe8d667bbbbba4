"""Entry points that measure the GPU refuse to run without one, and the
shared compile-cache helper honours ``JAX_COMPILATION_CACHE_DIR``."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra, timeout=240):
    env = dict(os.environ, **env_extra)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_on_cpu(script):
    r = _run([script], {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout
    assert "platform cpu" in r.stderr


_PROBE = """
import jax, jax.numpy as jnp
from nvsf_tpu.compile_cache import enable_compile_cache
d = enable_compile_cache()
jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    from nvsf_tpu.compile_cache import DEFAULT_DIR
    env = {"JAX_PLATFORMS": "cpu"}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    else:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    r = _run(["-c", _PROBE], env)
    assert r.returncode == 0, r.stderr
    chosen, configured = r.stdout.split()[-2:]
    want = str(tmp_path) if env_dir else DEFAULT_DIR
    assert chosen == want and configured == want
    if env_dir:
        # the compiled program landed in the variable's directory
        assert any(os.scandir(tmp_path))
