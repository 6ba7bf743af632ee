"""Small shared helpers (the port of
:mod:`grafx_tpu.processors.core.utils`)."""

import inspect

import torch


def rms_difference(X, Y, eps=1e-7):
    """Sum of |log-RMS(X) - log-RMS(Y)| over the batch (gain-staging loss)."""
    X_rms = torch.log(torch.square(X).mean(dim=(-1, -2)) + eps)
    Y_rms = torch.log(torch.square(Y).mean(dim=(-1, -2)) + eps)
    return torch.sum(torch.abs(X_rms - Y_rms))


def accepts_noise_key(processor):
    """True if ``processor``'s call signature has an explicit
    ``noise_key`` parameter (the stochastic-processor contract).  An
    ``nn.Module`` is asked through its ``forward``.  Detection is by
    explicit name, never ``**kwargs``."""
    if inspect.isroutine(processor):
        target = processor
    else:
        target = getattr(type(processor), "forward", type(processor).__call__)
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        return False
    return "noise_key" in sig.parameters


_MISSING = object()


def lti_kind_of(processor):
    """LTI serial-fusion family of ``processor`` (render/fuse.py):
    ``"fir"`` (implements ``fir_kernel``), ``"iir"`` (exact-backend
    biquad cascade with ``biquad_kernel``), or ``None``.  A ``lti_kind``
    property arbitrates where present."""
    if processor is None:
        return None
    kind = getattr(processor, "lti_kind", _MISSING)
    if kind is not _MISSING:
        return kind
    return "fir" if hasattr(processor, "fir_kernel") else None


def normalize_impulse(ir, eps=1e-12):
    """Normalize an IR batch ``(B, C, L)`` to unit mean channel energy."""
    if ir.dim() != 3:
        raise ValueError(f"expected a (B, C, L) impulse response, got {tuple(ir.shape)}")
    e = torch.square(ir).sum(dim=2, keepdim=True).mean(dim=1, keepdim=True)
    return ir / torch.sqrt(e + eps)
