"""Audio processors of the ported slices (``nn.Module``s on tensors)."""

from grafx_tpu_torch.processors.container import (
    DryWet,
    GainStagingRegularization,
    ParallelMix,
    SerialChain,
)
from grafx_tpu_torch.processors.delay import MultitapDelay
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
from grafx_tpu_torch.processors.eq import (
    GraphicEqualizer,
    NewZeroPhaseFIREqualizer,
    ParametricEqualizer,
    ZeroPhaseFIREqualizer,
)
from grafx_tpu_torch.processors.filter import (
    AllPassFilter,
    BandPassFilter,
    BandRejectFilter,
    BaseParametricEqualizerFilter,
    BaseParametricFilter,
    BiquadFilter,
    FIRFilter,
    HighPassFilter,
    HighShelf,
    LowPassFilter,
    LowShelf,
    PeakingFilter,
    PoleZeroFilter,
    StateVariableFilter,
)
from grafx_tpu_torch.processors.nonlinear import TanhDistortion
from grafx_tpu_torch.processors.reverb import STFTMaskedNoiseReverb
from grafx_tpu_torch.processors.stereo import StereoGain

__all__ = [
    "AllPassFilter",
    "ApproxCompressor",
    "ApproxNoiseGate",
    "BallisticsEnvelopeFollower",
    "BandPassFilter",
    "BandRejectFilter",
    "BaseEnvelopeFollower",
    "BaseParametricEqualizerFilter",
    "BaseParametricFilter",
    "BiquadFilter",
    "Compressor",
    "DryWet",
    "FIRFilter",
    "FactorizedCompressor",
    "GainStagingRegularization",
    "GraphicEqualizer",
    "HighPassFilter",
    "HighShelf",
    "IIREnvelopeFollower",
    "LowPassFilter",
    "LowShelf",
    "MultitapDelay",
    "NewZeroPhaseFIREqualizer",
    "NoiseGate",
    "ParallelMix",
    "ParametricEqualizer",
    "PeakingFilter",
    "PoleZeroFilter",
    "STFTMaskedNoiseReverb",
    "SerialChain",
    "StateVariableFilter",
    "StereoGain",
    "TanhDistortion",
    "ZeroPhaseFIREqualizer",
]
