"""Bench smoke tests (SURVEY.md §4): each benchmark config runs at reduced
size in CI to guard compilation and wiring — not performance. Config 4
(1080p frames) is skipped on CPU where a single frame takes seconds."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent / "scripts"))

import bench_configs  # noqa: E402


@pytest.mark.parametrize("cfg_id", [1, 2, 3, 5])
def test_config_smoke(cfg_id):
    res = bench_configs.CONFIGS[cfg_id](quick=True)
    assert res.get("config") == cfg_id
    assert "error" not in res, res


def test_headline_bench_smoke():
    import bench

    res = bench.bench_throughput(batch=2, h=32, w=48, repeats=1, iters=2)
    assert res["images_per_sec"] > 0
    # every result names the device it ran on
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] >= 1


def test_headline_bench_needs_a_gpu(capsys):
    import bench

    assert bench.main([]) != 0
    assert "needs a GPU" in capsys.readouterr().err
