"""Graph factories and the parameter optimizer."""

from grafx_tpu_torch.models.console import Console, bench_console, bench_trainer
from grafx_tpu_torch.models.optimize import GraphParameterOptimizer

__all__ = ["Console", "GraphParameterOptimizer", "bench_console", "bench_trainer"]
