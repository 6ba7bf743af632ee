"""Audio processors of the ported slices (``nn.Module``s on tensors)."""

from grafx_tpu_torch.processors.dynamics import (
    ApproxCompressor,
    ApproxNoiseGate,
    BallisticsEnvelopeFollower,
    BaseEnvelopeFollower,
    Compressor,
    FactorizedCompressor,
    IIREnvelopeFollower,
    NoiseGate,
)
from grafx_tpu_torch.processors.delay import MultitapDelay
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
    "ApproxCompressor",
    "ApproxNoiseGate",
    "BallisticsEnvelopeFollower",
    "BaseEnvelopeFollower",
    "BaseParametricEqualizerFilter",
    "Compressor",
    "FactorizedCompressor",
    "GraphicEqualizer",
    "HighShelf",
    "IIREnvelopeFollower",
    "LowShelf",
    "MultitapDelay",
    "NoiseGate",
    "ParametricEqualizer",
    "PeakingFilter",
    "STFTMaskedNoiseReverb",
    "StereoGain",
    "TanhDistortion",
]
