"""Render engine: scheduling, plan compilation, fusion, the executor and
the streaming renderer."""

from grafx_tpu_torch.render.fuse import (
    FusedBiquadChain,
    FusedDynamicsChain,
    fuse_parameters,
    fuse_serial_lti,
)
from grafx_tpu_torch.render.graph import make_render_fn, render_grafx
from grafx_tpu_torch.render.order import compute_render_order, reorder_for_fast_render
from grafx_tpu_torch.render.prepare import RenderData, prepare_render
from grafx_tpu_torch.render.streaming import StreamRenderer

__all__ = [
    "FusedBiquadChain",
    "FusedDynamicsChain",
    "RenderData",
    "StreamRenderer",
    "compute_render_order",
    "fuse_parameters",
    "fuse_serial_lti",
    "make_render_fn",
    "prepare_render",
    "render_grafx",
    "reorder_for_fast_render",
]
