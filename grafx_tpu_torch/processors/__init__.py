"""Audio processors of the serving slice (``nn.Module``s on tensors)."""

from grafx_tpu_torch.processors.dynamics import Compressor, NoiseGate
from grafx_tpu_torch.processors.eq import GraphicEqualizer, ParametricEqualizer
from grafx_tpu_torch.processors.filter import (
    BaseParametricEqualizerFilter,
    HighShelf,
    LowShelf,
    PeakingFilter,
)
from grafx_tpu_torch.processors.nonlinear import TanhDistortion
from grafx_tpu_torch.processors.reverb import STFTMaskedNoiseReverb
from grafx_tpu_torch.processors.stereo import StereoGain

__all__ = [
    "BaseParametricEqualizerFilter",
    "Compressor",
    "GraphicEqualizer",
    "HighShelf",
    "LowShelf",
    "NoiseGate",
    "ParametricEqualizer",
    "PeakingFilter",
    "STFTMaskedNoiseReverb",
    "StereoGain",
    "TanhDistortion",
]
