"""Benchmark of the PyTorch and CUDA port (``blade_torch``), driven by data.

``python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one NVIDIA GPU.
"""
