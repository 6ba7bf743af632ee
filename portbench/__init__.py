"""The benchmark of grafx_tpu_torch on one NVIDIA H100: ``run.py`` runs a
cell of ``BENCHMARK.json``; ``calibrate.py`` reads the limits' readings."""
