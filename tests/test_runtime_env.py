"""Process-level rules, each checked in a fresh interpreter: where the
persistent compile cache goes, and chip_smoke.py's refusal to run without a
GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the package puts
    the cache at the fixed <checkout>/.jax_cache."""
    want = str(tmp_path / "cache") if from_env else os.path.join(REPO, ".jax_cache")
    env = _env(JAX_COMPILATION_CACHE_DIR=want) if from_env else _env()
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, svo_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_fails_without_gpu():
    """On a CPU-only process the device phase refuses to run: non-zero exit
    and no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
