"""Signal buffers, row reads and writes, fan-in aggregation and batch
expansion for the render executor (the port of
:mod:`grafx_tpu.render.core`).

The ``"array"`` buffer is written out of place (``slice_scatter``,
``index_copy``), as ``grafx_tpu``'s functional ``.at[].set``: a
processor may keep a view of the rows it read for its backward pass, and
an in-place write into the same tensor would make autograd refuse it or
differentiate the wrong values.  A ``"one-by-one"`` plan keeps a Python
list of per-node tensors, so node outputs may differ in length.

Fan-in adds no two values by atomics, so a render and its gradient on
the card are a function of their inputs, as ``grafx_tpu``'s are on the
TPU: a ``scatter`` aggregation sums each segment's rows by a static plan
(:class:`StaticSegmentSum`: one reduction, backward a gather), and an
index read that repeats a row (:class:`StaticGather`) takes that sum as
its backward in place of ``index_select``'s atomic accumulation.
"""

import functools

import torch

from grafx_tpu_torch.render.prepare import plan_segment_sum


@functools.cache
def _cached_index_tensor(idx, device):
    with torch.inference_mode(False):  # also for renders that autograd tracks
        return torch.tensor(idx, device=device)


def _index_tensor(idx, device):
    """A plan's gather or scatter indices as a tensor on ``device``, made
    once per (indices, device) and shared by every render: a warm render
    then copies nothing from the host, which a CUDA-graph capture would
    refuse.  While ``torch.export`` traces, a fresh tensor (it becomes a
    constant of the exported program)."""
    if torch.compiler.is_exporting():
        return torch.tensor(idx, device=device)
    return _cached_index_tensor(idx, device)


def _access_rows(access):
    if access.method == "slice":
        return list(range(access.idx[0], access.idx[1]))
    return list(access.idx)


def create_signal_buffer(method, num_buffers, input_signals):
    """The signal buffer with the input rows filled (reference:
    core.py:6-33): ``(num_buffers, C, L)`` for a 3-dim input, ``(B,
    num_buffers, C, L)`` for a 4-dim one.

    For ``"one-by-one"`` it is a list of ``num_buffers`` rows, each the
    input row's ``(1, C, L)`` (``(B, 1, C, L)`` for a 4-dim input) or
    ``None`` until a stage writes it.
    """
    ndim = input_signals.dim()
    if ndim not in (3, 4):
        raise ValueError(f"input_signals must be 3- or 4-dim, got {ndim}")
    node_dim = ndim - 3
    num_sources = input_signals.shape[node_dim]
    if method == "one-by-one":
        rows = list(input_signals.split(1, dim=node_dim))
        return rows + [None] * (num_buffers - num_sources)
    shape = list(input_signals.shape)
    shape[node_dim] = num_buffers - num_sources
    return torch.cat([input_signals, input_signals.new_zeros(shape)], dim=node_dim)


def _tracks_grad(x):
    return x.requires_grad and torch.is_grad_enabled()


def _segment_sum(x, plan, dim):
    """Rows of ``x`` along ``dim`` summed into ``plan.num_segments``
    segments (a :class:`~grafx_tpu_torch.render.prepare.SegmentSum`):
    one reduction over equal sorted runs; else each row copied into its
    own slot of a zero grid, one row of slots a segment, and one
    reduction over the slots.  Each segment's rows add in one fixed
    order."""
    if plan.run:
        return x.unflatten(dim, (plan.num_segments, plan.run)).sum(dim + 1)
    shape = list(x.shape)
    shape[dim] = len(plan.filled) * plan.width
    grid = x.new_zeros(shape).index_copy_(dim, _index_tensor(plan.slots, x.device), x)
    sums = grid.unflatten(dim, (len(plan.filled), plan.width)).sum(dim + 1)
    if len(plan.filled) == plan.num_segments:
        return sums
    shape[dim] = plan.num_segments
    return sums.new_zeros(shape).index_copy_(dim, _index_tensor(plan.filled, x.device), sums)


class StaticSegmentSum(torch.autograd.Function):
    """:func:`_segment_sum` whose backward gathers each row's segment
    (:class:`StaticGather`): no accumulation, so no atomics."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _segment_sum(x, plan, dim)

    @staticmethod
    def backward(ctx, grad):
        return StaticGather.apply(grad, ctx.plan, ctx.dim), None, None


class StaticGather(torch.autograd.Function):
    """Rows ``plan.idx`` of ``x`` along ``dim``; the backward sums the
    gradient of each source row over its reads (:class:`StaticSegmentSum`)
    where ``index_select``'s would add them by atomics."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return x.index_select(dim, _index_tensor(plan.idx, x.device))

    @staticmethod
    def backward(ctx, grad):
        return StaticSegmentSum.apply(grad, ctx.plan, ctx.dim), None, None


def read_tensor(x, access, dim=0):
    """Read rows of a tensor along ``dim`` per a static access pattern.
    Under autograd, an index read that repeats a row is a
    :class:`StaticGather` (one addend a row needs none)."""
    if access.method == "slice":
        lo, hi = access.idx
        return x.narrow(dim, lo, hi - lo)
    if access.method == "index":
        if _tracks_grad(x):
            plan = plan_segment_sum(access.idx, x.shape[dim])
            if plan.width > 1:
                return StaticGather.apply(x, plan, dim)
        return x.index_select(dim, _index_tensor(access.idx, x.device))
    raise ValueError(f"Unavailable read method: {access.method}")


def read_tensor_or_tensor_dict(x, access, dim=0, postprocess=None):
    """Recursively read a tensor or nested dict of tensors
    (reference: core.py:53-77)."""
    if isinstance(x, dict):
        return {
            k: read_tensor_or_tensor_dict(v, access, dim=dim, postprocess=postprocess)
            for k, v in x.items()
        }
    if isinstance(x, list):  # one-by-one buffer
        rows = [x[i] for i in _access_rows(access)]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=dim)
    y = read_tensor(x, access, dim=dim)
    return postprocess(y) if postprocess is not None else y


def write_tensor(method, buf, y, access, dim=0):
    """Write ``y`` into the buffer's rows ``access`` along ``dim``; returns
    the new buffer (reference: core.py:68-84).  An array buffer is never
    written in place (module docstring); a one-by-one list is, one entry
    a row."""
    if access.method == "none":
        return buf  # e.g. MIMO "out" nodes own no buffer rows
    if method == "one-by-one":
        for p, r in enumerate(_access_rows(access)):
            buf[r] = y.narrow(dim, p, 1)
        return buf
    if access.method not in ("slice", "index"):
        raise ValueError(f"Unavailable write method: {access.method}")
    rows = _access_rows(access)
    # broadcast as .at[].set does (a mono outlet into a stereo buffer)
    y = y.expand(buf.shape[:dim] + (len(rows),) + buf.shape[dim + 1 :])
    if access.method == "slice":
        return buf.slice_scatter(y, dim=dim, start=access.idx[0], end=access.idx[1])
    return buf.index_copy(dim, _index_tensor(access.idx, buf.device), y)


def aggregate_tensor(x, aggregation, dim=0):
    """Fan-in aggregation (reference: core.py:101-112;
    ``grafx_tpu/render/core.py:85-121``): ``sum`` collapses all rows into
    one, ``scatter`` segment-sums rows into stage-node positions by the
    aggregation's static plan, without atomics (:class:`StaticSegmentSum`).
    """
    if aggregation.method == "none":
        return x
    if aggregation.method == "sum":
        return x.sum(dim=dim, keepdim=True)
    if aggregation.method == "scatter":
        if _tracks_grad(x):
            return StaticSegmentSum.apply(x, aggregation.segments, dim)
        return _segment_sum(x, aggregation.segments, dim)
    raise ValueError(f"Unavailable aggregation method: {aggregation.method}")


def expand_tensor_or_tensor_dict(x, expand, dim=0):
    """Broadcast a new batch axis of size ``expand`` at ``dim``
    (reference: core.py:115-134); a view, no copy."""
    if isinstance(x, dict):
        return {k: expand_tensor_or_tensor_dict(v, expand, dim) for k, v in x.items()}
    x = x.unsqueeze(dim)
    sizes = [-1] * x.dim()
    sizes[dim] = expand
    return x.expand(sizes)


def flatten_batch_and_node(x):
    """Merge leading (batch, node) dims (reference: core.py:138-140)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))
