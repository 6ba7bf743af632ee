"""TanhDistortion with a pre gain and its inverse as the post gain:
``tanh(g x) / g``."""

import torch


def parameter_size(args):
    if (not args.get("pre_post_gain", True) or not args.get("inverse_post_gain", True)
            or args.get("remove_dc") or args.get("use_bias")):
        raise NotImplementedError("the reference has the default tanh distortion only")
    return {"log_pre_gain": (1,)}


def render(x, p, args, ctx):
    parameter_size(args)
    g = torch.exp(p["log_pre_gain"])[..., None]
    return torch.tanh(x * g) / g


def flops(rows, channels, length, args):
    return rows * channels * length * 3
