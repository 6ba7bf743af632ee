"""Mid/side <-> left/right conversions
(reference: src/grafx/processors/core/midside.py:4-17)."""

import torch


def lr_to_ms(x, mult=0.5):
    """Left/right -> mid/side along the channel axis (-2)."""
    left, right = x[..., 0:1, :], x[..., 1:2, :]
    out = torch.cat([left + right, left - right], dim=-2)
    if mult is not None:
        out = out * mult
    return out


def ms_to_lr(x):
    """Mid/side -> left/right along the channel axis (-2)."""
    mid, side = x[..., 0:1, :], x[..., 1:2, :]
    return torch.cat([mid + side, mid - side], dim=-2)
