"""Which path runs the per-pixel graph: the one backend decision.

Every entry point (pipeline, video, blocks, bench, the graft entry) asks
here, so the rule is written once:

* on a GPU, the compiled fused kernel wherever ``kernels.kernel_covers``
  says the config is covered, and the plain ``jax.numpy`` graph otherwise;
* on the CPU, no kernel: the plain graph;
* the Pallas interpreter only when a caller asks for it (``interpret``),
  never as a stand-in for a missing GPU.
"""

from __future__ import annotations

import jax

from low_light_image_enhancement_tpu.config import PipelineConfig


def platform() -> str:
    """The default JAX backend: "gpu" or "cpu"."""
    return jax.default_backend()


def use_kernel(cfg: PipelineConfig, *, force_jnp: bool = False,
               interpret: bool = False) -> bool:
    """Whether the fused retinex kernel runs for ``cfg``.

    ``force_jnp`` pins the plain graph; ``interpret`` asks for the kernel
    under the Pallas interpreter on any backend (tests)."""
    from low_light_image_enhancement_tpu.kernels import kernel_covers

    if force_jnp or not cfg.use_pallas or not kernel_covers(cfg):
        return False
    return interpret or platform() == "gpu"


def require_devices(n: int, what: str) -> None:
    """Raise unless at least ``n`` devices exist: a multi-device setting
    never shrinks to the devices at hand."""
    have = len(jax.devices())
    if n > have:
        raise ValueError(f"{what}={n} needs {n} devices, have {have}")
