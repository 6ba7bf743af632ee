"""Compiled paths: CUDA-graph capture behind the entry points' ``jit=True``.

The counterpart of ``jax.jit`` in :mod:`grafx_tpu` (``make_render_fn``,
the optimizer's update, the streaming renderer's block step and
``step_many``'s ``lax.scan``).  PyTorch runs eagerly, and the host's
enqueue of some thousand small device ops sets the time of every path; a
CUDA graph records those launches once and replays them with one call.

:class:`CapturedFunction` wraps ``fn(*args, **kwargs)``:

* on CUDA arguments the first call with a new signature (the argument
  tree's structure with its keywords and non-tensor leaves, every tensor
  leaf's shape, dtype and device, grad and inference mode) runs ``fn``
  eagerly on a side stream and returns its results.  It builds the kernels, fills
  :func:`~grafx_tpu_torch.ops.ballistics.walk_slots` and the cuFFT plan
  cache, and makes lazy state (an optimizer's);
* the second call captures ``fn`` on static copies of its arguments into a
  ``torch.cuda.CUDAGraph`` and replays it, as a new shape re-traces under
  ``jax.jit``; later calls copy their arguments into those buffers (one
  ``_foreach_copy_``) and replay;
* every call returns fresh tensors (a clone of each output), so two
  calls' results never alias, as JAX's arrays never do;
* Python's cyclic garbage collector is paused while a capture runs: a
  collection there can free another capture's graph (an optimizer and its
  ``CapturedFunction`` form a cycle), and freeing a graph invalidates the
  capture underway (``cudaErrorStreamCaptureInvalidated``);
* a capture that fails raises; nothing gives way to the eager path on a
  CUDA tensor.

On the CPU, and while ``torch.export`` traces, ``fn`` runs as it is.
Arguments that need autograd are refused on every device: a replay
carries no autograd history, so such a caller passes ``jit=False``.

What ``fn`` reads besides its arguments (parameters it updates in place,
a renderer's caches, a processor's buffers) is baked into the graph by
address, and Python scalars (a learning rate, a block length) by value.
The kernel wrappers' launch counters count the warm-up and capture calls,
not replays.
"""

import gc
import time

import torch
from torch.utils import _pytree as pytree


def check_capturable(optimizer):
    """Raise unless ``optimizer.step()`` can be captured in a CUDA graph:
    every parameter group has ``capturable=True`` (Adam, AdamW, RMSprop,
    ...), or the optimizer is ``torch.optim.SGD``, which keeps no step
    count on the host.  Others (Adam without ``capturable``, Adagrad,
    LBFGS) read or keep host values in ``step()``."""
    default = isinstance(optimizer, torch.optim.SGD)
    if not all(group.get("capturable", default) for group in optimizer.param_groups):
        raise ValueError(
            f"{type(optimizer).__name__} cannot be captured in a CUDA graph: build"
            " it with capturable=True (where it takes that option) or use SGD, or"
            " pass jit=False to run the step eagerly"
        )


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return x


def _on_side_stream(fn, args, kwargs, device):
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn(*args, **kwargs)
    current.wait_stream(side)
    return out


class _Graph:
    """One captured call: static argument buffers, the graph and its
    outputs."""

    def __init__(self, fn, name, leaves, spec):
        leaves = [x.detach().clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        self.inputs = [x for x in leaves if isinstance(x, torch.Tensor)]
        self.graph = torch.cuda.CUDAGraph()
        args, kwargs = pytree.tree_unflatten(leaves, spec)
        start = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                out = fn(*args, **kwargs)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA-graph capture of {name} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.seconds = time.perf_counter() - start
        self.out_leaves, self.out_spec = pytree.tree_flatten(out)

    def replay(self, tensors):
        if self.inputs:
            torch._foreach_copy_(self.inputs, tensors)
        self.graph.replay()
        leaves = [x.clone() if isinstance(x, torch.Tensor) else x for x in self.out_leaves]
        return pytree.tree_unflatten(leaves, self.out_spec)


class CapturedFunction:
    """``fn(*args, **kwargs)`` replayed from one CUDA graph per argument
    signature (module docstring).  ``capture_seconds`` lists each
    capture's host seconds, in order."""

    def __init__(self, fn, name=None):
        self.fn = fn
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self.capture_seconds = []
        self._warm = set()
        self._graphs = {}

    def __call__(self, *args, **kwargs):
        if torch.compiler.is_exporting():
            return self.fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise ValueError(
                f"{self.name}: an argument requires grad under grad mode, and a"
                " CUDA-graph replay carries no autograd history; pass jit=False"
                " to differentiate through it"
            )
        if not tensors or tensors[0].device.type != "cuda":
            return self.fn(*args, **kwargs)
        device = tensors[0].device
        if any(t.device != device for t in tensors):
            raise ValueError(f"{self.name}: every tensor argument must be on {device}")
        key = (spec, tuple(_leaf_key(x) for x in leaves), torch.is_grad_enabled(),
               torch.is_inference_mode_enabled())
        graph = self._graphs.get(key)
        if graph is None:
            if key not in self._warm:
                self._warm.add(key)
                return _on_side_stream(self.fn, args, kwargs, device)
            graph = _Graph(self.fn, self.name, leaves, spec)
            self._graphs[key] = graph
            self.capture_seconds.append(graph.seconds)
        return graph.replay(tensors)
