"""The main path needs no Pillow and no orbax: with both hidden
(``sys.modules[name] = None``, so any import of them raises), the package
and its entry modules import, ``llie enhance`` runs on a PNG, and a
training checkpoint saves and restores."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MODULES = ["low_light_image_enhancement_tpu", "low_light_image_enhancement_tpu.cli",
           "low_light_image_enhancement_tpu.io",
           "low_light_image_enhancement_tpu.utils",
           "low_light_image_enhancement_tpu.serving",
           "low_light_image_enhancement_tpu.http_server",
           "low_light_image_enhancement_tpu.train",
           "low_light_image_enhancement_tpu.video"]

_PRELUDE = """
import json, sys
for name in ("PIL", "PIL.Image", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None
import jax
jax.config.update("jax_platforms", "cpu")
"""


def _run(body, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _PRELUDE + textwrap.dedent(body)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    return _run(f"""
        import importlib
        res = {{}}
        for m in {MODULES!r}:
            try:
                importlib.import_module(m)
                res[m] = "ok"
            except Exception as e:
                res[m] = repr(e)
        print(json.dumps(res))
    """, tmp_path_factory.mktemp("imports"))


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_pil_and_orbax(imported, module):
    assert imported[module] == "ok"


@pytest.mark.parametrize("method", ["retinex", "curve"])
def test_cli_enhance_png_without_pil(tmp_path, method):
    res = _run(f"""
        from low_light_image_enhancement_tpu import cli
        from low_light_image_enhancement_tpu.data.synth import synth_pair
        from low_light_image_enhancement_tpu.io.codec import (
            decode_image, encode_image)
        low, _ = synth_pair(0, 40, 56)
        encode_image(low, "dark.png")
        rc = cli.main(["enhance", "dark.png", "out.png",
                       "--method", "{method}"])
        out = decode_image("out.png")
        print(json.dumps({{"rc": rc, "shape": list(out.shape),
                          "brighter": float(out.mean()) > float(low.mean())}}))
    """, tmp_path)
    assert res == {"rc": 0, "shape": [40, 56, 3], "brighter": True}


def test_checkpoint_roundtrip_without_orbax(tmp_path):
    res = _run("""
        import numpy as np
        import jax.numpy as jnp
        from low_light_image_enhancement_tpu.utils import CheckpointManager
        state = {"params": {"w": jnp.arange(6.0).reshape(2, 3)},
                 "step": jnp.asarray(7)}
        mgr = CheckpointManager("ckpt", max_to_keep=2)
        for step in (1, 2, 3):
            mgr.save(state, step=step)
        back = mgr.restore_latest(state)
        print(json.dumps({
            "latest": mgr.latest_step(),
            "kept": sorted(p.name for p in mgr.root.iterdir()),
            "equal": bool(np.array_equal(back["params"]["w"],
                                         state["params"]["w"])),
            "step": int(back["step"])}))
    """, tmp_path)
    assert res == {"latest": 3, "kept": ["2", "3"], "equal": True, "step": 7}
