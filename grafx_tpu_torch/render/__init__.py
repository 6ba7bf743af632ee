"""Render engine: scheduling, plan compilation, fusion, the executor, the
streaming renderer and their CUDA-graph capture."""

from grafx_tpu_torch.render.compiled import CapturedFunction, check_capturable
from grafx_tpu_torch.render.fuse import (
    FusedBiquadChain,
    FusedDynamicsChain,
    FusedFIRChain,
    fuse_parameters,
    fuse_serial_fir,
    fuse_serial_lti,
)
from grafx_tpu_torch.render.graph import make_render_fn, render_grafx
from grafx_tpu_torch.render.order import compute_render_order, reorder_for_fast_render
from grafx_tpu_torch.render.prepare import RenderData, prepare_render
from grafx_tpu_torch.render.streaming import StreamRenderer

__all__ = [
    "CapturedFunction",
    "FusedBiquadChain",
    "FusedDynamicsChain",
    "FusedFIRChain",
    "RenderData",
    "StreamRenderer",
    "check_capturable",
    "compute_render_order",
    "fuse_parameters",
    "fuse_serial_fir",
    "fuse_serial_lti",
    "make_render_fn",
    "prepare_render",
    "render_grafx",
    "reorder_for_fast_render",
]
