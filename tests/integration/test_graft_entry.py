"""Entry-point regression tests: __graft_entry__ must work with
JAX_PLATFORMS=cpu and a forced host device count, whatever devices the
host has."""

import os
import subprocess
import sys
import textwrap


def _run(code: str) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    # generous: the box has one core and the full suite may be loading it
    # concurrently; 420s measured flaky under a second pytest process
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_dryrun_multichip_8():
    out = _run(
        """
        import __graft_entry__ as g
        g.dryrun_multichip(8)
        """
    )
    assert "OK" in out


def test_entry_compiles_single_chip():
    # Pin the platform via jax.config (conftest-style): the test
    # compile-checks entry() on the CPU whatever devices the host has.
    out = _run(
        """
        import jax
        jax.config.update("jax_platforms", "cpu")
        import __graft_entry__ as g
        fn, args = g.entry()
        res = jax.jit(fn)(*args)
        print("ENTRY", res.shape, res.dtype)
        """
    )
    assert "ENTRY (4, 400, 600, 3) uint8" in out
