"""Ahead-of-time export of renders and stream steps for serving.

The port of :mod:`grafx_tpu.serving` on ``torch.export``: a scheduled
render (or any function of ``(input_signals, params)`` that
``torch.export`` can trace) is exported once, saved to bytes with
``torch.export.save``, and restored by :func:`load_render` in any
process that imports this package, with no graph construction,
scheduling or tracing at load time.  The artifact holds the whole render
plan: schedule, slices, index and processor constants, and the
ballistics kernels as the custom ops ``torch.ops.grafx_tpu_torch.*``
(``ops/ballistics.py``), which run the CUDA kernel on the card and the
plain version on the CPU.  The program keeps the device of the example
inputs it was exported with.  On the card a loaded program replays a
CUDA graph (:class:`~grafx_tpu_torch.render.compiled.CapturedFunction`).

Typical flow::

    render = make_render_fn(processors, plan)
    blob = export_render(render, example_signals, example_params)
    Path("console.pt2").write_bytes(blob)
    # ... serving process ...
    render = load_render(Path("console.pt2").read_bytes())
    out = render(signals, params)
"""

import io
import warnings

import torch
import torch._prims_common
from torch.utils import _pytree as pytree

# the custom ops must be registered before an artifact that calls them loads
import grafx_tpu_torch.ops.ballistics  # noqa: F401
from grafx_tpu_torch.render.compiled import CapturedFunction


def _only_output(result):
    # render_grafx returns (out, intermediates, buffer); exporting just
    # the master output keeps the artifact's output signature stable
    if isinstance(result, tuple) and len(result) == 3:
        return result[0]
    return result


class _Module(torch.nn.Module):
    """``fn`` as the ``forward`` that ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, example_args):
    return _save(_exported(fn, example_args))


def _exported(fn, example_args):
    with torch.no_grad():
        return torch.export.export(_Module(fn), example_args, strict=False)


def _save(program):
    program.example_inputs = None  # else saved too: a request's audio
    # A constant is saved as the bytes of its storage (after a move to the
    # CPU) and rebuilt with its strides and offset: give each its own
    # storage, with its strides where it is dense (a permuted spectrum) and
    # contiguous where it is a view with gaps, which that move would pack.
    for name, value in program.constants.items():
        if isinstance(value, torch.Tensor) and not value.is_contiguous():
            dense = torch._prims_common.is_non_overlapping_and_dense_or_false(value)
            program.constants[name] = (
                torch.empty_strided(value.shape, value.stride(), dtype=value.dtype,
                                    device=value.device).copy_(value)
                if dense else value.contiguous()
            )
    buffer = io.BytesIO()
    with warnings.catch_warnings():
        # torch warns of every constant that is not contiguous; each now
        # owns its storage, which is what it saves
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, buffer)
    return buffer.getvalue()


def export_render(render_fn, example_signals, example_params):
    """Serialize a render as a ``torch.export`` artifact.

    Args:
        render_fn: ``f(input_signals, params)``, e.g. the closure from
            :func:`grafx_tpu_torch.render.make_render_fn` (a compiled one
            runs eagerly while ``torch.export`` traces it); its ``(out,
            intermediates, buffer)`` return is narrowed to the master
            output.
        example_signals, example_params: tensors and a parameter tree
            fixing shapes, dtypes and the device (values are ignored).

    Returns:
        ``bytes``, loadable with :func:`load_render`.
    """
    return _export(lambda signals, params: _only_output(render_fn(signals, params)),
                   (example_signals, example_params))


def load_render(blob):
    """Restore an exported render; returns ``f(signals, params) -> out``,
    on the card one CUDA-graph replay per call (the first call of a shape
    runs eagerly, the second captures)."""
    program = CapturedFunction(torch.export.load(io.BytesIO(blob)).module(), name="load_render")

    def serve(signals, params):
        with torch.no_grad():
            return program(signals, params)

    return serve


def export_stream_step(renderer, example_block, blocks_per_step=1):
    """Serialize a :class:`~grafx_tpu_torch.render.StreamRenderer`'s block
    step as an artifact for real-time serving.

    The exported function is ``step(x_block, state) -> (y_block,
    new_state)`` with the renderer's parameter-dependent caches shipped
    beside it (parameters are frozen at export).  The initial stream
    state ships inside the artifact, so the serving process needs nothing
    but audio blocks::

        step, state = load_stream_step(blob)
        while streaming:
            y, state = step(x, state)

    The state's top level is keyed by stage index; the artifact's keys
    are strings (as ``grafx_tpu``'s are at its export boundary).  The
    caches (some of them strided views, such as a blocked filter's
    Toeplitz kernels) are the program's arguments and are saved with
    ``torch.save``, which keeps every view's layout on any device; saved
    as the program's constants they would be packed.

    A state's shapes may change from block to block: a ballistics walk's
    carries the samples of the link its last block ended in
    (:func:`~grafx_tpu_torch.ops.ballistics.ballistics_stream`), as many
    as the samples streamed so far modulo the link, where a block is not
    whole links.  The artifact holds one program per state shape the
    stream reaches (stepped with ``example_block`` from the initial
    state), and a call runs the one its state's shapes select.

    Args:
        renderer: a built ``StreamRenderer``.
        example_block: ``(num_sources, C, block_len)`` tensor fixing the
            block's shape, dtype and device.
        blocks_per_step: serve this many consecutive blocks a call
            (``StreamRenderer.step_many``): the step takes and returns
            ``(blocks_per_step, *block_shape)``.

    Returns:
        ``bytes`` (``torch.save`` of the saved programs, each beside its
        state's shapes, the initial state and the caches), loadable with
        :func:`load_stream_step`.
    """
    state0 = {str(k): v for k, v in renderer.init_state().items()}
    impl = renderer._step if blocks_per_step == 1 else renderer._step_many
    leaves, spec = pytree.tree_flatten(renderer._caches)
    caches = [x for x in leaves if isinstance(x, torch.Tensor)]

    def step(x_block, state, cache_tensors):
        tensors = iter(cache_tensors)
        cache = pytree.tree_unflatten(
            [next(tensors) if isinstance(x, torch.Tensor) else x for x in leaves], spec
        )
        y, new_state = impl(x_block, {int(k): v for k, v in state.items()}, cache)
        return y, {str(k): v for k, v in new_state.items()}

    example = example_block
    if blocks_per_step != 1:
        example = example_block.expand((blocks_per_step,) + tuple(example_block.shape)).contiguous()
    programs, state = {}, state0
    while _shapes(state) not in programs:
        key, program = _shapes(state), _exported(step, (example, state, caches))
        state = _returned_state(program)
        programs[key] = _save(program)
    payload = io.BytesIO()
    torch.save({"programs": list(programs.items()), "state": state0, "caches": caches}, payload)
    return payload.getvalue()


def _returned_state(program):
    """The state a traced stream step returns, as zeros of the shapes the
    trace gave it (nothing runs): the next state to trace from."""
    out = next(n for n in program.graph.nodes if n.op == "output").args[0]
    out = out[len(out) - program.call_spec.out_spec.num_leaves:]  # the user's outputs

    def zeros(node):
        if not isinstance(node, torch.fx.Node):
            return node
        v = node.meta["val"]
        return torch.zeros(v.shape, dtype=v.dtype, device=v.device)

    return pytree.tree_unflatten([zeros(n) for n in out], program.call_spec.out_spec)[1]


def _shapes(state):
    """The shapes of a stream state's tensors, in tree order."""
    return tuple(tuple(x.shape) for x in pytree.tree_leaves(state) if isinstance(x, torch.Tensor))


def load_stream_step(blob):
    """Restore an exported streaming step; returns ``(step, state0)`` with
    ``step(x_block, state) -> (y_block, new_state)``, on the card one
    CUDA-graph replay per call (the caches baked into the graph)."""
    payload = torch.load(io.BytesIO(blob), weights_only=True)
    caches = payload["caches"]
    programs = {}
    for shapes, saved in payload["programs"]:
        module = torch.export.load(io.BytesIO(saved)).module()
        programs[shapes] = CapturedFunction(
            lambda x_block, state, module=module: module(x_block, state, caches),
            name="load_stream_step",
        )

    def step(x_block, state):
        with torch.no_grad():
            return programs[_shapes(state)](x_block, state)

    return step, payload["state"]


__all__ = [
    "export_render",
    "load_render",
    "export_stream_step",
    "load_stream_step",
]
