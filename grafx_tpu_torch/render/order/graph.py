"""Render-order facade: dispatch over graph / tensor inputs.

Behavioral parity with the reference
(reference: src/grafx/render/order/graph.py:15-94).
"""

from grafx_tpu_torch.data._multigraph import relabel_nodes
from grafx_tpu_torch.data.conversion import convert_to_tensor
from grafx_tpu_torch.data.graph import GRAFX
from grafx_tpu_torch.data.tensor import GRAFXTensor
from grafx_tpu_torch.render.order.tensor import (
    compute_render_order_tensor,
    node_id_from_render_order,
    return_render_ordered_tensor,
)


def compute_render_order(G_any, method="beam", **kwargs):
    """Compute a rendering order for a graph or tensor graph.

    Returns ``(type_sequence, render_order)`` where ``type_sequence`` is a
    list of type *indices* per stage and ``render_order`` assigns each node
    its stage.
    """
    if isinstance(G_any, GRAFX):
        return compute_render_order_tensor(convert_to_tensor(G_any), method, **kwargs)
    if isinstance(G_any, GRAFXTensor):
        return compute_render_order_tensor(G_any, method, **kwargs)
    raise TypeError(f"Invalid graph type: {type(G_any)}")


def reorder_for_fast_render(G_any, method="beam", **kwargs):
    """Compute a render order and permute node ids so same-(type, order)
    nodes are contiguous — contiguous slice reads in the render plan."""
    if isinstance(G_any, GRAFX):
        return return_render_ordered_graph(G_any, method, **kwargs)
    if isinstance(G_any, GRAFXTensor):
        return return_render_ordered_tensor(G_any, method, **kwargs)
    raise TypeError(f"Invalid input type: {type(G_any)}")


def return_render_ordered_graph(G, method, **kwargs):
    """Graph-form variant: writes ``rendering_order`` per node, relabels
    node ids to the fast-render order, and records the type sequence."""
    type_sequence, render_order = compute_render_order(G, method, **kwargs)
    for i, order in zip(G.nodes, render_order):
        G.nodes[i]["rendering_order"] = int(order)
    node_id = node_id_from_render_order(render_order).tolist()
    mapping = dict(enumerate(node_id))
    G = relabel_nodes(G, mapping)
    G = _get_sorted_graph(G)
    G.type_sequence = [G.config.node_types[t] for t in type_sequence]
    G.rendering_order_method = method
    return G


def _get_sorted_graph(G):
    H = GRAFX()
    H.add_nodes_from(sorted(G.nodes(data=True)))
    H.add_edges_from(sorted(G.edges(data=True), key=lambda e: (e[0], e[1])))
    H.graph = G.graph.copy()
    return H
