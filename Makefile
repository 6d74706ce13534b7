# Developer entry points. Test runs force the 8-fake-device CPU platform via
# tests/conftest.py; bench, chip-smoke and test-gpu need an NVIDIA GPU.

.PHONY: test test-gpu bench chip-smoke bench-configs bench-dp eval demo train-weights clean

test:
	python -m pytest tests/ -x -q

test-gpu:
	LLIE_TEST_ON_GPU=1 python -m pytest -m gpu tests/ -q

bench:
	python bench.py

chip-smoke:
	python chip_smoke.py

bench-configs:
	python scripts/bench_configs.py --quick

bench-dp:
	python scripts/bench_dp_scaling.py --quick

eval:
	python scripts/eval_lol.py --max-images 8

demo:
	python examples/demo.py

train-weights:
	python scripts/train_weights.py --steps 4000 --batch 16 --crop 256 \
		--models curve hybrid fcn decom

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
	rm -rf .pytest_cache demo_out
