"""Persistent-compile-cache placement: one knob, JAX_COMPILATION_CACHE_DIR;
without it, a fixed directory inside the checkout."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from low_light_image_enhancement_tpu.utils import compile_cache
from low_light_image_enhancement_tpu.utils.compile_cache import (
    DEFAULT_DIR,
    enable_compile_cache,
)

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins_and_cache_lands_there(tmp_path):
    """A fresh process with the variable set: the program sets no other
    directory, and a compiled program is written under the variable's."""
    target = tmp_path / "env-cache"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from low_light_image_enhancement_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "assert d == jax.config.jax_compilation_cache_dir, d\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n"
        "print(d)\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(target),
               JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(target)
    assert any(target.rglob("*")), "nothing was cached"


def test_default_is_a_fixed_path_in_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compile_cache()
    assert got == str(REPO / ".jax_cache") == str(DEFAULT_DIR)
    assert Path(got).is_dir()
    assert jax.config.jax_compilation_cache_dir == got


def test_default_dir_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_cli_enables_the_cache(monkeypatch):
    from low_light_image_enhancement_tpu import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache",
                        lambda: calls.append(1) or "x")
    with pytest.raises(SystemExit):
        cli.main([])  # no subcommand: argparse exits after the cache call
    assert calls == [1]
