"""Signal-row reads, fan-in aggregation and batch expansion for the
render executor (the port of :mod:`grafx_tpu.render.core`, for the
``"stages"`` buffer mode: there is no threaded signal buffer to write)."""

import functools

import torch


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


def read_tensor(x, access, dim=0):
    """Read rows of a tensor along ``dim`` per a static access pattern."""
    if access.method == "slice":
        lo, hi = access.idx
        return x.narrow(dim, lo, hi - lo)
    if access.method == "index":
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
    y = read_tensor(x, access, dim=dim)
    return postprocess(y) if postprocess is not None else y


def aggregate_tensor(x, aggregation, dim=0):
    """Fan-in aggregation (reference: core.py:101-112): ``sum`` collapses
    all rows into one, ``scatter`` segment-sums rows into stage-node
    positions."""
    if aggregation.method == "none":
        return x
    if aggregation.method == "sum":
        return x.sum(dim=dim, keepdim=True)
    if aggregation.method == "scatter":
        shape = list(x.shape)
        shape[dim] = aggregation.num_segments
        idx = _index_tensor(aggregation.idx, x.device)
        return x.new_zeros(shape).index_add_(dim, idx, x)
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
