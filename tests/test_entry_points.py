"""Entry-point plumbing: the compile-cache helper and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax

from icp_tpu.runtime import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_after(monkeypatch, env_value):
    prev = jax.config.jax_compilation_cache_dir
    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    try:
        returned = cache.enable_compile_cache()
        return returned, jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """A set JAX_COMPILATION_CACHE_DIR is left to JAX: nothing is set."""
    before = jax.config.jax_compilation_cache_dir
    returned, configured = _cache_dir_after(monkeypatch, str(tmp_path))
    assert returned == str(tmp_path)
    assert configured == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    returned, configured = _cache_dir_after(monkeypatch, None)
    assert returned == configured == os.path.join(ROOT, ".jax_cache")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("ICP_TEST_DEVICE", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_refuses(tmp_path):
    """Copied out of the repository it has no program to drive."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
