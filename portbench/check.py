"""The comparison that decides ``correct``: the plain reference
(``reference/``, float64) run on the inputs the timed path was given, and
the numbers that hold the program's results against it.

A control is the reference computed in a lower precision in the
program's place (``Precision``).
"""

import math
import statistics

import torch

from portbench.reference import graph

SCALE_FLOOR = 1e-3  # a leaf whose reference norm is under this share of the median leaf's is left out


class Precision:
    """A reference run's arithmetic: ``"float64"`` (the reference), or a
    control in float32 with ``operand`` rounding the operands of every
    convolution and filter (the signal and the impulse response), as a
    matrix product on the tensor cores rounds its operands: ``"tf32"``
    (10-bit mantissa), or ``"bf16"`` (7 bits), which also rounds every
    node's input, output and parameters (``rnd``), as signals and weights
    kept in bfloat16 are."""

    def __init__(self, name):
        if name not in ("float64", "tf32", "bf16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.operand = None if name == "float64" else _Round(name).apply
        self.rnd = self.operand if name == "bf16" else _identity


def _identity(x):
    return x


def _Round(name):
    """A rounding to ``name`` whose gradient passes through, rounded the
    same way."""
    def rnd(x):
        if name == "tf32":
            bits = x.float().contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x.to(torch.bfloat16).to(x.dtype)

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return rnd(x) if torch.is_floating_point(x) else x

        @staticmethod
        def backward(ctx, g):
            return rnd(g)

    return Round


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def render(config, stems, params, rows, precision):
    """The reference's ``(R, B, C, L)`` outputs, without gradients."""
    with torch.no_grad():
        return graph.render(config, cast(stems, precision.dtype), cast(params, precision.dtype),
                            rows, precision)


def train(config, steps, params, rows, lr, precision, half_batch=False):
    """Follow ``len(steps)`` SGD steps of MSE on ``[(stems, target)]`` from
    ``params`` (``{type: {name: (nodes, *size)}}``): ``{"losses": [...],
    "grad": {(type, name): sum of squares of the first gradient},
    "change": {(type, name): sum of squares of the change}}``.
    ``half_batch`` plants a fault: the loss over the first half of the
    mixes only."""
    p0 = {(t, n): v.to(precision.dtype)[None] for t, names in params.items() for n, v in names.items()}
    p = {k: v.clone() for k, v in p0.items()}
    losses, first = [], None
    for stems, target in steps:
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        tree = {}
        for (t, n), v in leaves.items():
            tree.setdefault(t, {})[n] = v
        y = graph.render(config, stems.to(precision.dtype)[None], tree, rows, precision)[0]
        target = target.to(precision.dtype)[:, 0]
        if half_batch:
            half = y.shape[0] // 2
            y, target = y[:half], target[:half]
        loss = torch.mean((y - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(torch.sum(g.double() ** 2)) for k, g in zip(leaves, grads)}
        p = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    change = {k: float(torch.sum((p[k] - p0[k]).double() ** 2)) for k in p}
    return {"losses": losses, "grad": first, "change": change}


def output_error(outputs, refs, sample_rate=None, above_hz=None):
    """The widest relative RMS error of a mix: ``max sqrt(sum (y - r)^2 /
    sum r^2)`` over the ``(B, C, L)`` outputs and their references; with
    ``above_hz``, of their content above that frequency (the sums over
    the bins of the mixes' spectra from there up)."""
    worst = 0.0
    for y, r in zip(outputs, refs):
        r = r.double()
        d = y.to(r) - r
        if above_hz is not None:
            keep = torch.fft.rfftfreq(r.shape[-1], 1.0 / sample_rate) >= above_hz
            d, r = torch.fft.rfft(d)[..., keep], torch.fft.rfft(r)[..., keep]
        e = torch.sum(d.abs() ** 2, dim=(-1, -2)) / torch.sum(r.abs() ** 2, dim=(-1, -2))
        worst = max(worst, float(torch.sqrt(e).max()))
    return worst


def norm_gaps(prog, ref):
    """``(worst gap, every leaf's gap, left out)``: per leaf ``|norm_prog
    - norm_ref|`` over the larger of ``norm_ref`` and the median leaf's,
    leaves with a reference norm under ``SCALE_FLOOR`` of the median left
    out."""
    norms = {k: math.sqrt(v) for k, v in ref.items()}
    median = statistics.median(norms.values())
    gaps, left_out = {}, []
    for k, n_ref in norms.items():
        if n_ref < SCALE_FLOOR * median:
            left_out.append("/".join(k))
            continue
        gaps["/".join(k)] = abs(math.sqrt(prog.get(k, 0.0)) - n_ref) / max(n_ref, median)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], gaps, left_out


def train_numbers(prog, ref):
    """``(numbers, notes)`` of a training cell: the compared numbers, and
    the leaves left out and the worst leaf of each gap of norms."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad, grad_leaves, grad_out = norm_gaps(prog["grad"], ref["grad"])
    change, change_leaves, change_out = norm_gaps(prog["change"], ref["change"])
    notes = {"left_out": sorted(set(grad_out) | set(change_out)),
             "worst_leaf": {"grad_gap": max(grad_leaves, key=grad_leaves.get),
                            "change_gap": max(change_leaves, key=change_leaves.get)},
             "leaves": {"grad_gap": grad_leaves, "change_gap": change_leaves}}
    return {"loss_gap": max(losses), "grad_gap": grad, "change_gap": change}, notes
