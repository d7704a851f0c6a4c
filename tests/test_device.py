"""Compile-cache placement and the device checks the runnable scripts use."""

import os
import subprocess
import sys

import jax
import pytest

from tissue_analysis_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is configured
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.CHECKOUT == REPO
    assert device.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_dir_same_across_processes():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    code = (
        "import jax; from tissue_analysis_tpu.utils import device; "
        "p = device.enable_compile_cache(); "
        "print(p, jax.config.jax_compilation_cache_dir)"
    )
    outs = [
        subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=300, check=True,
        ).stdout.split()
        for _ in range(2)
    ]
    want = os.path.join(REPO, ".jax_cache")
    assert outs[0] == outs[1] == [want, want]


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        device.require_gpu()


def test_describe_device_fields():
    d = device.describe_device()
    assert d["platform"] == jax.devices()[0].platform == "cpu"
    assert d["kind"] == jax.devices()[0].device_kind
    assert d["count"] == len(jax.devices())
    assert d["nvidia_smi"] is None or isinstance(d["nvidia_smi"], str)
