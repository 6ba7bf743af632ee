"""Render engine: scheduling, plan compilation, fusion, the executor, the
streaming renderer and their CUDA-graph capture."""

from grafx_tpu_torch.render.compiled import CapturedFunction, check_capturable
from grafx_tpu_torch.render.core import (
    aggregate_tensor,
    create_signal_buffer,
    expand_tensor_or_tensor_dict,
    flatten_batch_and_node,
    read_tensor,
    read_tensor_or_tensor_dict,
    write_tensor,
)
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
from grafx_tpu_torch.render.prepare import (
    RenderData,
    check_aggregate_method,
    check_and_convert_arange,
    create_per_type_indices,
    prepare_render,
)
from grafx_tpu_torch.render.streaming import StreamRenderer

__all__ = [
    "CapturedFunction",
    "FusedBiquadChain",
    "FusedDynamicsChain",
    "FusedFIRChain",
    "RenderData",
    "StreamRenderer",
    "aggregate_tensor",
    "check_aggregate_method",
    "check_and_convert_arange",
    "check_capturable",
    "compute_render_order",
    "create_per_type_indices",
    "create_signal_buffer",
    "expand_tensor_or_tensor_dict",
    "flatten_batch_and_node",
    "fuse_parameters",
    "fuse_serial_fir",
    "fuse_serial_lti",
    "make_render_fn",
    "prepare_render",
    "read_tensor",
    "read_tensor_or_tensor_dict",
    "render_grafx",
    "reorder_for_fast_render",
    "write_tensor",
]
