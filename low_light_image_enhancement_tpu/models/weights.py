"""Flat .npz parameter serialization for shipping small pretrained weights
inside the repo (utils.checkpoint handles training checkpoints; npz is the portable
distribution format — no directory trees, loads anywhere)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

_SEP = "::"

# Repo-shipped default weights, keyed by pipeline method.
_WEIGHTS_DIR = Path(__file__).resolve().parent.parent / "weights"
PRETRAINED = {
    # round-4 recipe: paired + denoise-in-loss (18.56 dB / 0.689 SSIM ->
    # 19.12 / 0.741 on eval-15)
    "curve": _WEIGHTS_DIR / "curve_cnn.npz",
    # hybrid curves are trained on retinex-boosted inputs (the image they
    # adjust), not raw lows — separate weights. Round-4 recipe of record:
    # paired objective with the pipeline's denoise tail INSIDE the loss
    # (train_weights.py --models hybrid --denoise-in-loss), which moved
    # hybrid from 18.9 dB / 0.665 SSIM to 19.27 / 0.728 on eval-15 — see
    # docs/PERFORMANCE.md @84fe805 "denoise-in-loss" section.
    "hybrid": _WEIGHTS_DIR / "curve_hybrid.npz",
    "fcn": _WEIGHTS_DIR / "fcn.npz",
    # Round-5 default: the materialized-relit-image objective (w_relit —
    # the decomposition loss plus an L1+SSIM term on the image the decom
    # pipeline actually ships) beats the pure-decomposition round-3
    # weights on the DEFAULT bilateral config on every metric
    # (20.04 dB / 0.898 SSIM / dE 18.0 vs 19.6 / 0.742 — eval matrix,
    # docs/PERFORMANCE.md @84fe805 guided-in-loss round-5 section). The old set
    # stays addressable as NAMED["decom_v4"].
    "decom": _WEIGHTS_DIR / "decom_relit.npz",
}


def save_params(params: Dict[str, Any], path: Union[str, Path]) -> None:
    """Nested dict-of-dicts of arrays -> flat npz."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{_SEP}{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_params(path: Union[str, Path]) -> Dict[str, Any]:
    """Flat npz -> nested dict-of-dicts of numpy arrays."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


# Shipped weights addressable by NAME (beyond the per-method defaults):
# "zeroref" is the rehabilitated zero-reference curve recipe of record
# (scripts/sweep_zeroref.py; docs/PERFORMANCE.md @84fe805 zero-reference section) —
# trained with no ground truth, unlike the paired curve_cnn.npz default.
NAMED = dict(PRETRAINED)
NAMED["zeroref"] = _WEIGHTS_DIR / "curve_zeroref.npz"
# Round-5 guided-in-loss retrains (VERDICT r4 item 3: tail choice is part
# of the training contract — these trained THROUGH the quality-preset
# guided tail; pair them with denoise_taps="guided", guided_radius=4):
NAMED["hybrid_guided"] = _WEIGHTS_DIR / "curve_hybrid_guided.npz"
NAMED["curve_guided"] = _WEIGHTS_DIR / "curve_cnn_guided.npz"
NAMED["fcn_guided"] = _WEIGHTS_DIR / "fcn_guided.npz"
# decom with the materialized-relit-image objective (w_relit): trained
# through the guided tail / with no tail respectively.
NAMED["decom_relit_guided"] = _WEIGHTS_DIR / "decom_relit_guided.npz"
NAMED["decom_relit"] = _WEIGHTS_DIR / "decom_relit.npz"
# the pre-round-5 pure-decomposition-objective weights (superseded as the
# method default by decom_relit; kept for reproducing round-3/4 numbers)
NAMED["decom_v4"] = _WEIGHTS_DIR / "decom.npz"


def load_pretrained(method: str) -> Optional[Dict[str, Any]]:
    """Load the repo-shipped weights for a pipeline method, or None."""
    path = PRETRAINED.get(method)
    if path is not None and path.exists():
        return load_params(path)
    return None


def resolve_weights(name_or_path: Union[str, Path]) -> Dict[str, Any]:
    """Load params from a shipped name (``zeroref``, ``curve``, ``hybrid``,
    ``fcn``, ``decom``) or an .npz path. Raises FileNotFoundError with the
    known names listed when neither resolves."""
    p = Path(name_or_path)
    if p.exists():
        return load_params(p)
    named = NAMED.get(str(name_or_path))
    if named is not None and named.exists():
        return load_params(named)
    raise FileNotFoundError(
        f"weights {name_or_path!r} is neither a file nor a shipped name "
        f"(shipped: {sorted(k for k, v in NAMED.items() if v.exists())})"
    )
