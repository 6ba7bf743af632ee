"""DSP cores shared across the processor library."""

from grafx_tpu_torch.processors.core.envelope import Ballistics, TruncatedOnePoleIIRFilter
from grafx_tpu_torch.processors.core.geq import GraphicEqualizerBiquad
from grafx_tpu_torch.processors.core.iir import IIRFilter
from grafx_tpu_torch.processors.core.midside import lr_to_ms, ms_to_lr
from grafx_tpu_torch.processors.core.utils import normalize_impulse

__all__ = [
    "Ballistics",
    "GraphicEqualizerBiquad",
    "IIRFilter",
    "TruncatedOnePoleIIRFilter",
    "lr_to_ms",
    "ms_to_lr",
    "normalize_impulse",
]
