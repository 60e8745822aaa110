"""The entry points' environment: the compile-cache location,
chip_smoke.py's refusal to run without a GPU or outside the repository,
and the package's former name."""
import importlib
import os
import shutil
import subprocess
import sys

import jax
import pytest

from graphlily_jax.utils.compile_cache import (CHECKOUT_ROOT,
                                                enable_compile_cache)

SMOKE = os.path.join(CHECKOUT_ROOT, "chip_smoke.py")


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.exists(os.path.join(CHECKOUT_ROOT, "chip_smoke.py"))


def test_former_package_name_is_an_alias():
    """The one other top-level graphlily package is an alias: it and its
    submodules are graphlily_jax's own module objects."""
    import graphlily_jax
    import graphlily_jax.apps.bfs
    (alias,) = [name for name in os.listdir(CHECKOUT_ROOT)
                if name.startswith("graphlily_") and name != "graphlily_jax"
                and os.path.isfile(os.path.join(CHECKOUT_ROOT, name,
                                                "__init__.py"))]
    sys.modules.pop(alias, None)
    with pytest.warns(DeprecationWarning):
        assert importlib.import_module(alias) is graphlily_jax
    bfs = importlib.import_module(alias + ".apps.bfs")
    assert bfs is graphlily_jax.apps.bfs
    assert bfs.BFS is graphlily_jax.apps.bfs.BFS


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_chip_smoke_refuses_without_gpu():
    out = _run_smoke(CHECKOUT_ROOT, _clean_env())
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no GPU" in out.stderr


def test_chip_smoke_needs_the_repository(tmp_path):
    shutil.copy(SMOKE, tmp_path)
    out = _run_smoke(tmp_path, _clean_env())
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole one-card smoke run; only where a GPU is present."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=CHECKOUT_ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"ok": true' in out.stdout.splitlines()[-1]
