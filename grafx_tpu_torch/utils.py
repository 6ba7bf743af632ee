"""Utility functions: type counting, parameter init, tensor permutation.

The port of :mod:`grafx_tpu.utils`.  Parameters are plain nested dicts of
``torch`` tensors, initialized from an explicit ``torch.Generator``.
"""

import numpy as np
import torch


def get_node_ids_from_type(G, node_type):
    """Node ids of a specific type (reference: utils.py:8-26)."""
    return [i for i, d in G.nodes(data=True) if d["node_type"] == node_type]


def count_nodes_per_type(G, types_to_count=None):
    """Count nodes per type (reference: utils.py:28-57)."""
    if types_to_count is not None:
        counts = {k: 0 for k in types_to_count}
    elif G.config is not None:
        counts = {k: 0 for k in G.config.node_types}
    else:
        counts = {}
    for _, data in G.nodes(data=True):
        node_type = data["node_type"]
        if types_to_count is not None:
            if node_type in types_to_count:
                counts[node_type] += 1
        else:
            counts[node_type] = 1 + counts.get(node_type, 0)
    return counts


def _int_to_tuple(x):
    if isinstance(x, int):
        return (x,)
    if isinstance(x, tuple):
        return x
    raise TypeError(f"Parameter shape with type {type(x)} is not supported")


def create_empty_parameters_from_shape_dict(
    parameter_shapes, num_nodes, generator, std=1e-2, root=True,
    dtype=torch.float32,
):
    """Build a nested parameter dict from a shape spec
    (reference: utils.py:90-131).  Leaves are ``N(0, std^2)`` tensors with
    a leading node-batch dim of ``num_nodes``, drawn on the CPU from
    ``generator`` in the dict's key order."""
    if isinstance(parameter_shapes, dict):
        return {
            k: create_empty_parameters_from_shape_dict(
                v, num_nodes, generator, std=std, root=False, dtype=dtype
            )
            for k, v in parameter_shapes.items()
        }
    shape = (num_nodes,) + _int_to_tuple(parameter_shapes)
    parameter = std * torch.randn(shape, generator=generator, dtype=dtype)
    if root:
        return {"parameter": parameter}
    return parameter


def create_empty_parameters(
    processors, G, std=1e-2, generator=None, device="cpu", dtype=torch.float32
):
    """Initialize a full per-type parameter dict for a graph
    (reference: utils.py:60-87).

    Args:
        processors: dict mapping node type to processor (each must expose
            ``parameter_size()``).
        G: the graph (used to count nodes per type).
        std: init standard deviation.
        generator: CPU ``torch.Generator`` (default: seeded with 0).  The
            draws happen on the CPU, so a seed gives the same parameters
            on every device.
        device: where the returned tensors live.

    Returns:
        Nested dict: type -> name -> tensor ``(num_nodes, *shape)``.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    counts = count_nodes_per_type(G, list(processors))
    out = {}
    for processor_type, proc in processors.items():
        out[processor_type] = create_empty_parameters_from_shape_dict(
            proc.parameter_size(), counts[processor_type], generator,
            std=std, dtype=dtype,
        )
    return tree_to(out, device)


def parameters_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays (e.g. ``grafx_tpu`` parameters passed
    through ``jax.tree.map(np.asarray, params)``) -> the same dict of
    float32 ``torch`` tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: parameters_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix=""):
    """``[(path, leaf)]`` of a nested dict, depth first in sorted key
    order; paths join keys with ``/``."""
    items = []
    for k in sorted(tree):
        v = tree[k]
        items += tree_items(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return items


def tree_leaves(tree):
    """The leaves of a nested dict, in :func:`tree_items` order."""
    return [leaf for _, leaf in tree_items(tree)]


def check_device(device):
    """``torch.device(device)``, raising where a CUDA device is asked for
    and torch sees none: the entry points default to the card and never
    fall back to the CPU on their own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA device;"
            " pass device='cpu' to run on the CPU"
        )
    return device


def tree_to(tree, device):
    """Move every tensor of a nested dict to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def permute_grafx_tensor(
    G_t,
    node_id,
    node_attrs=("node_types", "rendering_orders"),
    id_attrs=("edge_indices",),
):
    """Permute node/edge attributes by a node-id permutation
    (reference: utils.py:134-174).

    ``node_id[i]`` is the new id of the node currently at position ``i``.
    """
    node_id = np.asarray(node_id)
    inverse = np.empty_like(node_id)
    inverse[node_id] = np.arange(len(node_id))

    new_dict = {}
    for k, v in G_t.__dict__.items():
        if v is None:
            new_dict[k] = None
        elif k in node_attrs:
            new_dict[k] = np.asarray(v)[inverse]
        elif k in id_attrs:
            new_dict[k] = node_id[np.asarray(v)]
        else:
            new_dict[k] = v
    return type(G_t)(**new_dict)
