"""Graph factories, the parameter optimizer and the neural parameter
predictor."""

from grafx_tpu_torch.models.console import (
    Console,
    bench_console,
    bench_trainer,
    mastering_chain,
    mixing_console,
    simple_chain,
)
from grafx_tpu_torch.models.optimize import GraphParameterOptimizer
from grafx_tpu_torch.models.predictor import ParameterPredictor, audio_features

__all__ = [
    "Console",
    "GraphParameterOptimizer",
    "ParameterPredictor",
    "audio_features",
    "bench_console",
    "bench_trainer",
    "mastering_chain",
    "mixing_console",
    "simple_chain",
]
