"""Type-scheduling searches for the render order."""

from grafx_tpu_torch.render.order.graph import (
    compute_render_order,
    reorder_for_fast_render,
    return_render_ordered_graph,
)
from grafx_tpu_torch.render.order.tensor import (
    beam_search,
    compute_render_order_tensor,
    fixed_order_search,
    greedy_search,
    node_id_from_render_order,
    one_by_one_search,
    return_render_ordered_tensor,
)

__all__ = [
    "beam_search",
    "compute_render_order",
    "compute_render_order_tensor",
    "fixed_order_search",
    "greedy_search",
    "node_id_from_render_order",
    "one_by_one_search",
    "reorder_for_fast_render",
    "return_render_ordered_graph",
    "return_render_ordered_tensor",
]
