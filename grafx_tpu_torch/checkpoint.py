"""Checkpoint and resume (the port of :mod:`grafx_tpu.checkpoint`).

``grafx_tpu`` saves parameter trees with orbax; the port keeps its own
format: a tree of CPU tensors written by ``torch.save``, restored onto
the devices and dtypes of a ``like`` tree.  Graphs pickle (full
fidelity) or cross between the packages as the same JSON node-link text.
"""

import json
import os
import pickle

import torch

from grafx_tpu_torch.utils import tree_items, tree_map

PARAMS_FILE = "params.pt"


def _to_cpu(tree):
    """A nested dict/list of tensors (an optimizer's ``state_dict`` too)
    with every tensor detached and on the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_parameters(path, params):
    """Save a parameter tree (nested dicts of tensors) to the file ``path``
    as CPU tensors."""
    torch.save(_to_cpu(params), os.path.abspath(path))


def load_parameters(path, like=None):
    """Load a parameter tree saved by :func:`save_parameters`.

    Args:
        like: optional tree of tensors of the same structure and shapes:
            each loaded leaf goes to its leaf's device and dtype (else the
            tree stays on the CPU).
    """
    params = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if like is None:
        return params
    got = [(k, tuple(v.shape)) for k, v in tree_items(params)]
    want = [(k, tuple(v.shape)) for k, v in tree_items(like)]
    if got != want:
        raise ValueError(f"{path}: saved leaves {got} do not match {want}")
    return tree_map(lambda v, ref: v.to(device=ref.device, dtype=ref.dtype), params, like)


def save_graph(path, G):
    """Pickle a :class:`GRAFX` graph (nodes, edges, graph attributes)."""
    with open(path, "wb") as f:
        pickle.dump(G, f)


def load_graph(path):
    """Unpickle a graph written by :func:`save_graph` (only load files
    this program wrote: unpickling runs code)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def graph_to_json(G):
    """Portable JSON node-link form, the same text as ``grafx_tpu``'s for
    the same graph (config reduced to its node-type dict; rebuild a
    NodeConfigs from it on load)."""
    config = G.graph.get("config")
    return json.dumps(
        {
            "nodes": [
                {"id": i, **{k: v for k, v in d.items() if _is_jsonable(v)}}
                for i, d in G.nodes(data=True)
            ],
            "edges": [
                {"source": s, "dest": t, **d} for s, t, d in G.edges(data=True)
            ],
            "graph": {
                k: v
                for k, v in G.graph.items()
                if k != "config" and _is_jsonable(v)
            },
            "config": None if config is None else config.node_type_dict,
        }
    )


def graph_from_json(s):
    """A graph from :func:`graph_to_json`'s text (or ``grafx_tpu``'s)."""
    from grafx_tpu_torch.data.configs import NodeConfigs
    from grafx_tpu_torch.data.graph import GRAFX

    data = json.loads(s)
    config = None
    if data["config"] is not None:
        # strip the auto-injected utility types; NodeConfigs re-adds them
        user_cfg = {k: v for k, v in data["config"].items() if k not in ("in", "out", "mix")}
        config = NodeConfigs(user_cfg if user_cfg else list(user_cfg))
    G = GRAFX(config=config)
    for node in data["nodes"]:
        node = dict(node)
        node_id = node.pop("id")
        G.add_node(node_id, **node)
    for edge in data["edges"]:
        edge = dict(edge)
        s_, t_ = edge.pop("source"), edge.pop("dest")
        G.add_edge(s_, t_, **edge)
    for k, v in data["graph"].items():
        G.graph[k] = v
    return G


def _is_jsonable(v):
    return isinstance(v, (str, int, float, bool, list, dict, type(None)))


def save_session(directory, G, params, metadata=None):
    """Save a full optimization session: graph, parameters, metadata."""
    os.makedirs(directory, exist_ok=True)
    save_graph(os.path.join(directory, "graph.pkl"), G)
    save_parameters(os.path.join(directory, PARAMS_FILE), params)
    if metadata is not None:
        with open(os.path.join(directory, "metadata.json"), "w") as f:
            json.dump(metadata, f)


def load_session(directory, like=None):
    """Load a session saved by :func:`save_session`; returns ``(G, params,
    metadata)`` (``like`` as for :func:`load_parameters`)."""
    G = load_graph(os.path.join(directory, "graph.pkl"))
    params = load_parameters(os.path.join(directory, PARAMS_FILE), like=like)
    meta_path = os.path.join(directory, "metadata.json")
    metadata = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return G, params, metadata
