"""Observability and persistence utilities: JSONL metrics, profiling hooks,
npz checkpointing, the persistent compile cache."""

from low_light_image_enhancement_tpu.utils.logging import JSONLLogger, get_logger
from low_light_image_enhancement_tpu.utils.profiling import profile_trace, stage
from low_light_image_enhancement_tpu.utils.checkpoint import CheckpointManager
from low_light_image_enhancement_tpu.utils.compile_cache import (
    enable_compile_cache,
)

__all__ = [
    "JSONLLogger",
    "get_logger",
    "profile_trace",
    "stage",
    "CheckpointManager",
    "enable_compile_cache",
]
