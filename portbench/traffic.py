"""The one generator of the benchmark's inputs: every traffic mix is a
data file (``traffic/<name>.json``) that this module reads.  Everything is
drawn from the run's seed on the run's device, in a few large calls."""

import torch


def generator(seed, device, stream):
    """A generator on ``device`` for one ``stream`` of draws of a seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % 2**63)


def stems(spec, shape, gen, device):
    """``(..., S, C, L)`` stems.  ``quiet_passages``: Gaussian noise whose
    ``blocks`` equal blocks per stem are each loud with probability
    ``loud_share`` and else ``quiet_db`` below, so that gates and knees
    act and have gradients."""
    if spec["kind"] != "quiet_passages":
        raise ValueError(f"unknown stems {spec['kind']!r}")
    blocks, length = spec["blocks"], shape[-1]
    if length % blocks:
        raise ValueError(f"{length} samples do not split into {blocks} blocks")
    x = torch.randn(shape, generator=gen, device=device)
    loud = torch.rand(shape[:-2] + (1, blocks), generator=gen, device=device) < spec["loud_share"]
    quiet = 10.0 ** (spec["quiet_db"] / 20.0)
    scale = torch.where(loud, 1.0, quiet).repeat_interleave(length // blocks, dim=-1)
    return x * scale


def target(spec, x):
    """The ``(B, 1, C, L)`` fitting target (shaped as the render's output,
    one ``out`` node) of ``(B, S, C, L)`` stems.  ``dry_sum``: the stems'
    sum times ``gain``."""
    if spec["kind"] != "dry_sum":
        raise ValueError(f"unknown target {spec['kind']!r}")
    return spec["gain"] * x.sum(dim=-3, keepdim=True)


def parameters(sizes, counts, sets, std, gen, device):
    """``sets`` parameter sets for the unfused graph, ``N(0, std^2)``:
    ``{type: {name: (sets, nodes of type, *size)}}``, drawn in one call in
    the order of ``sizes`` (types, then names)."""
    shapes = [(t, name, (sets, counts[t]) + size)
              for t, names in sizes.items() for name, size in names.items()]
    total = sum(torch.Size(s).numel() for _, _, s in shapes)
    flat = std * torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for t, name, shape in shapes:
        n = torch.Size(shape).numel()
        out.setdefault(t, {})[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


def pick(params, i):
    """Set ``i`` of :func:`parameters`."""
    return {t: {name: v[i] for name, v in names.items()} for t, names in params.items()}
