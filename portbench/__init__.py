"""The PyTorch/CUDA port's benchmark: see run.py and BENCHMARK.json at the repo root."""
