"""The benchmark of cim_tpu_torch, the PyTorch and CUDA port: one cell a run
(``python -m benchmark.run``), cells named in BENCHMARK.json."""
