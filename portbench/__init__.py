"""The benchmark of `deeplearning4j_tpu_torch` (the PyTorch and CUDA port):
`run.py` runs one cell of `BENCHMARK.json` and prints its result line.
Imports neither JAX nor the JAX package."""
