"""Graph visualization (the port of :mod:`grafx_tpu.draw`): matplotlib
on the host, imported when a figure is drawn, not when this package is."""

from grafx_tpu_torch.draw.edge import add_edge_curve, cubic_bezier, draw_edge
from grafx_tpu_torch.draw.graph import draw_grafx, postprocess_figure
from grafx_tpu_torch.draw.node import draw_node
from grafx_tpu_torch.draw.position import (
    compute_node_position,
    compute_rank,
    estimate_chain,
)
from grafx_tpu_torch.draw.style import NodeColorHandler

__all__ = [
    "NodeColorHandler",
    "add_edge_curve",
    "compute_node_position",
    "compute_rank",
    "cubic_bezier",
    "draw_edge",
    "draw_grafx",
    "draw_node",
    "estimate_chain",
    "postprocess_figure",
]
