"""StereoGain: each channel times the exp of its log gain."""

import torch


def parameter_size(args):
    return {"log_gain": (2,)}


def render(x, p, args, ctx):
    return x * torch.exp(p["log_gain"])[..., None]


def flops(rows, channels, length, args):
    return rows * channels * length
