"""Multi-device parallelism on ``torch.distributed`` (the port of
:mod:`grafx_tpu.parallel`).

``grafx_tpu`` builds meshes and shardings and lets XLA's GSPMD place the
collectives.  PyTorch has no such propagator for the render's ops, so
this module writes each collective itself, at the one place it belongs,
as an autograd function:

* :func:`_gather` all-gathers along a dimension; its backward returns
  the rank's own slice of the gradient (every rank computes the same
  thing downstream of it, so that gradient is not summed);
* :func:`_reduce_grad` is the identity, whose backward all-reduces (sums)
  the gradient: the gradient ``psum`` XLA inserts for replicated
  parameters, and the adjoint of taking a rank's rows of a replicated
  tensor.

A process is one rank.  The caller starts the ranks and initialises the
default process group (``torch.distributed.init_process_group``; NCCL
for tensors on the card, gloo for tensors on the CPU); a mesh lays those
ranks out along named axes.  Every rank holds the parameters whole
(replicated) and its own share of the sharded dimensions of the input
(:func:`local_shard`); every rank returns the whole, single-device
result.

* **data axis** (:func:`shard_render_step`, or
  :func:`make_sharded_render_fn` with :func:`batch_sharding`): each rank
  renders its rows of the graph batch; outputs are gathered.
* **node axis** (:func:`node_sharding`, and :func:`batch_node_sharding`
  on the 2-D mesh): each stage's flattened node rows split over the
  ranks and the stage output is gathered back.
* **time axis** (:func:`time_sharding`): each rank holds ``L / k``
  samples, gathered before the render, which then runs replicated, as
  XLA gathers around FFTs and recursions.
"""

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh as Mesh
from torch.utils import _pytree as pytree

from grafx_tpu_torch.processors.core.utils import accepts_noise_key
from grafx_tpu_torch.render.compiled import CapturedFunction
from grafx_tpu_torch.render.graph import render_grafx
from grafx_tpu_torch.utils import check_device, tree_map


def _check_group():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialised default process group:"
            " call torch.distributed.init_process_group first"
        )


def _mesh(device, shape, names, devices):
    _check_group()
    device = check_device(device)
    ranks = torch.arange(dist.get_world_size()) if devices is None else torch.as_tensor(devices)
    return Mesh(device.type, ranks[: int(torch.tensor(shape).prod())].reshape(shape),
                mesh_dim_names=names)


def make_mesh(n_devices=None, axis_name="batch", devices=None, device="cuda"):
    """A 1-D mesh over the first ``n_devices`` ranks of the default group
    (or over the ranks ``devices``).  ``device`` is where its tensors live:
    the card unless ``"cpu"`` is asked for; a card that is missing raises."""
    _check_group()
    n = n_devices or (dist.get_world_size() if devices is None else len(devices))
    return _mesh(device, (n,), (axis_name,), devices)


def make_mesh_2d(n_data, n_node, devices=None, device="cuda"):
    """A 2-D ``(data, node)`` mesh: graph batches shard over ``data`` while
    each stage's node rows split over ``node``."""
    return _mesh(device, (n_data, n_node), ("data", "node"), devices)


class P(tuple):
    """A partition spec: for each leading dimension of a tensor, the mesh
    axis it is sharded over, or ``None`` (``jax.sharding.PartitionSpec``).
    Dimensions past the spec are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class NamedSharding:
    """A mesh and a :class:`P` (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh, spec):
        names = mesh.mesh_dim_names or ()
        for axis in spec:
            if axis is not None and axis not in names:
                raise ValueError(f"{spec} names axis {axis!r}; the mesh has {names}")
        if len([a for a in spec if a is not None]) != len({a for a in spec if a is not None}):
            raise ValueError(f"{spec} shards two dimensions over one mesh axis")
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def batch_sharding(mesh, axis_name="batch"):
    """Sharding for a ``(B, |V_0|, C, L)`` batched input: shard ``B``."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh):
    """Fully replicated sharding (parameters)."""
    return NamedSharding(mesh, P())


def node_sharding(mesh, axis_name="batch"):
    """Sharding for ``(|V_0|, C, L)`` inputs: shard the node axis, and
    with it each stage's node rows (:func:`make_sharded_render_fn`), the
    analog of tensor parallelism for audio graphs.  For batched workloads
    prefer :func:`batch_sharding` (no signal traffic in the forward)."""
    return NamedSharding(mesh, P(axis_name))


def batch_node_sharding(mesh):
    """Sharding for ``(B, |V_0|, C, L)`` on a 2-D mesh: ``B`` over the
    ``data`` axis and the node axis over ``node``."""
    return NamedSharding(mesh, P("data", "node"))


def time_sharding(mesh, axis_name="batch", ndim=3):
    """Shard the trailing time axis (sequence parallelism).  FFT
    convolutions and recursions need the whole sequence, so the render
    gathers it first and then runs replicated: worth it only to spread a
    long input's storage.  Prefer :func:`batch_sharding` or
    :func:`node_sharding` otherwise."""
    return NamedSharding(mesh, P(*([None] * (ndim - 1) + [axis_name])))


def shares(n, k):
    """The sizes of ``k`` ranks' shares of ``n`` rows: equal where ``k``
    divides ``n``, else the first ``n % k`` ranks hold one more (17 over 2
    is 9 and 8)."""
    return [n // k + (r < n % k) for r in range(k)]


def local_shard(x, sharding, even=True):
    """This rank's shard of the global tensor ``x`` under ``sharding``
    (the per-rank side of ``jax.device_put``).  A sharded dimension that
    its mesh axis does not divide raises, as ``jax.device_put`` does,
    unless ``even=False``, which gives the uneven :func:`shares` that
    :func:`make_sharded_render_fn` also reads."""
    mesh = sharding.mesh
    for dim, axis in enumerate(sharding.spec):
        if axis is None:
            continue
        group = mesh.get_group(axis)
        k, r = dist.get_world_size(group), dist.get_rank(group)
        n = x.shape[dim]
        if even and n % k:
            raise ValueError(
                f"dimension {dim} of size {n} does not divide mesh axis {axis!r} of size {k}"
            )
        sizes = shares(n, k)
        x = x.narrow(dim, sum(sizes[:r]), sizes[r])
    return x.contiguous()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """All-gather of every rank's :func:`shares` of ``total`` rows along
    ``dim``, padded to the largest share on the wire and trimmed after.
    Backward: the rank's own rows of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, total, group):
        k, r = dist.get_world_size(group), dist.get_rank(group)
        sizes = shares(total, k)
        if x.shape[dim] != sizes[r]:
            raise ValueError(
                f"rank {r} holds {x.shape[dim]} of {total} rows along dim {dim};"
                f" its share is {sizes[r]}"
            )
        ctx.dim, ctx.start, ctx.size = dim, sum(sizes[:r]), sizes[r]
        if sizes[r] < sizes[0]:
            pad = list(x.shape)
            pad[dim] = sizes[0] - sizes[r]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(k)]
        dist.all_gather(parts, x, group=group)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


class _ReduceGrad(torch.autograd.Function):
    """The identity; backward: the sum of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceValue(torch.autograd.Function):
    """``scale`` times the sum of a value over the group; backward:
    ``scale`` times the gradient (every rank holds the same gradient of
    the reduced value, and its own term takes ``scale`` of it)."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x * scale

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


class _CountOnce(torch.autograd.Function):
    """A value that every rank of a group holds alike and that is summed
    over the group later: forward ``x / k``, so that the sum counts it
    once; backward the whole gradient, since each rank's copy passes its
    gradient on only to that rank's own rows."""

    @staticmethod
    def forward(ctx, x, k):
        return x / k

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x, dim, total, group):
    return _Gather.apply(x, dim, total, group)


def _reduce_grad(x, group):
    if not (isinstance(x, torch.Tensor) and x.requires_grad):
        return x
    return _ReduceGrad.apply(x, group)


def _gather_outputs(out, group, mean):
    """Every output tensor of a rank's rows (dim 0, equal shares) gathered;
    a 0-dim one averaged over the ranks (``mean``: a mean over rows) or
    summed (a sum over rows)."""
    k = dist.get_world_size(group)

    def combine(y):
        if not isinstance(y, torch.Tensor):
            return y
        if y.dim() == 0:
            return _ReduceValue.apply(y, group, 1.0 / k if mean else 1.0)
        return _gather(y, 0, y.shape[0] * k, group)

    return pytree.tree_map(combine, out)


def _compiled(fn, groups, jit, name):
    """``fn`` replayed from a CUDA graph where ``jit`` and its tensors are
    on the card (NCCL collectives capture; gloo's cannot, and asking
    raises); eager on the CPU."""
    if not jit:
        return fn
    captured = CapturedFunction(fn, name=name)

    def call(x, *args, **kwargs):
        if x.is_cuda:
            for group in groups:
                if dist.get_backend(group) != "nccl":
                    raise ValueError(
                        f"{name}: a {dist.get_backend(group)} group's collectives cannot be"
                        " captured in a CUDA graph; use NCCL, or pass jit=False"
                    )
        return captured(x, *args, **kwargs)

    call.captured = captured
    return call


def shard_render_step(render_fn, mesh, axis_name="batch", jit=True):
    """Wrap a batched render or loss ``render_fn(x, params, ...)`` so that
    each rank passes its own rows of the graph batch ``x`` (dim 0, equal
    shares over the mesh axis ``axis_name``; see :func:`local_shard`) and
    the replicated parameters, and gets the single-device result.

    The parameters enter through :func:`_reduce_grad` over the axis's
    group; every output tensor with a batch dimension (dim 0, rows in
    batch order) is gathered; a 0-dim output is taken as a mean over its
    rows and averaged over the ranks.  A loss that every rank computes
    on the gathered result then has single-device gradients on every
    rank.  Two rules follow:

    * do not also all-reduce the gradients afterwards, nor gather with
      ``torch.distributed.nn.functional.all_gather``, whose backward
      sums over ranks: either counts the gradient ``k`` times;
    * a processor that draws noise over its stage's rows draws it over
      the rank's rows here (:func:`make_sharded_render_fn` runs such
      stages whole).

    With ``jit`` and tensors on the card the whole call replays a CUDA
    graph (:class:`~grafx_tpu_torch.render.compiled.CapturedFunction`,
    as ``jax.jit`` compiles it): NCCL's collectives are captured; a gloo
    group on the card raises, so pass ``jit=False`` for it.  A compiled
    ``render_fn`` (``make_render_fn(jit=True)``) is unwrapped first.  As
    for every compiled path, parameters that need autograd are refused:
    differentiate through ``jit=False``, or capture the whole training
    step around it, as :class:`~grafx_tpu_torch.models.
    GraphParameterOptimizer` captures its update.
    """
    group = mesh.get_group(axis_name)
    if isinstance(render_fn, CapturedFunction):
        render_fn = render_fn.fn

    def step(x, params, *args, **kwargs):
        params = tree_map(lambda p: _reduce_grad(p, group), params)
        return _gather_outputs(render_fn(x, params, *args, **kwargs), group, mean=True)

    return _compiled(step, [group], jit, "shard_render_step")


# ---------------------------------------------------------------------------
# The node axis: stages split over ranks
# ---------------------------------------------------------------------------


def _map_tensors(fn, tree):
    return pytree.tree_map(lambda t: fn(t) if isinstance(t, torch.Tensor) else t, tree)


class _SplitStage:
    """A processor whose stage rows (dim 0 of every signal, parameter,
    common parameter and ``_cache`` tensor, after the executor flattened
    the batch into them) split over ``group``: each rank runs its
    :func:`shares` and the output and intermediates are gathered back.
    What is split passes :func:`_reduce_grad` first (its gradient is the
    sum of the ranks' rows).  A stage of fewer rows than ranks runs
    whole.  (The processors that report 0-dim intermediates, the
    containers, take a ``noise_key`` and so run as :class:`_WholeStage`.)"""

    def __init__(self, processor, group):
        self.processor, self.group = processor, group
        if hasattr(processor, "precompute"):
            self.precompute = processor.precompute

    def __call__(self, *signals, **kwargs):
        k, r = dist.get_world_size(self.group), dist.get_rank(self.group)
        rows = signals[0].shape[0]
        if rows < k:
            return self.processor(*signals, **kwargs)
        sizes = shares(rows, k)
        start, size = sum(sizes[:r]), sizes[r]

        def split(t):
            if t.dim() == 0 or t.shape[0] != rows:
                return t
            return _reduce_grad(t, self.group).narrow(0, start, size)

        out = self.processor(*_map_tensors(split, signals), **_map_tensors(split, kwargs))

        def gather(y):
            if y.dim() == 0 or y.shape[0] != size:
                raise ValueError(
                    f"{type(self.processor).__name__} returned {tuple(y.shape)} from {size}"
                    " rows; a split stage gathers outputs of its rows"
                )
            return _gather(y, 0, rows, self.group)

        return _map_tensors(gather, out)


class _WholeStage:
    """A processor that draws noise over its stage's full row shape
    (``noise_key``): it runs whole on every rank of the node group, with
    no :func:`_reduce_grad` (each rank's gradient is already the whole
    one).  Over a data group its rows are gathered first and the rank's
    rows taken after, so the noise is the single-device render's."""

    def __init__(self, processor, data_group):
        self.processor, self.data_group = processor, data_group
        if hasattr(processor, "precompute"):
            self.precompute = processor.precompute

    def __call__(self, *signals, noise_key=None, **kwargs):
        if noise_key is not None:
            kwargs["noise_key"] = noise_key
        if self.data_group is None:
            return self.processor(*signals, **kwargs)
        group = self.data_group
        k, r = dist.get_world_size(group), dist.get_rank(group)
        rows = signals[0].shape[0]

        def gather(t):
            if t.dim() == 0 or t.shape[0] != rows:
                return t
            return _gather(t, 0, rows * k, group)

        out = self.processor(*_map_tensors(gather, signals), **{
            name: v if name == "noise_key" else _map_tensors(gather, v)
            for name, v in kwargs.items()})

        def take(y):
            if y.dim() == 0:  # a sum over the batch's rows, summed at the end
                return _CountOnce.apply(y, k)
            return _reduce_grad(y, group).narrow(0, r * rows, rows)

        return _map_tensors(take, out)


def make_sharded_render_fn(processors, render_data, sharding, jit=True):
    """A render closure ``f(x, per_type_parameters, common_parameters=None,
    rng=None, return_buffer=False)`` (that of ``make_render_fn``) run by
    every rank of ``sharding.mesh`` on its shard of the input, returning
    the whole ``(output, intermediates, buffer)`` on every rank.

    ``sharding.spec`` names, for the input's dimensions ``(|V_0|, C, L)``
    or ``(B, |V_0|, C, L)``, the mesh axes they are sharded over:

    * the batch axis: each rank renders its rows of the batch, as
      :func:`shard_render_step` (0-dim intermediates, sums over rows, are
      summed);
    * the node axis: the input's rows are gathered at entry, and every
      processor stage's flattened rows split over the axis (a stage of
      fewer rows than ranks runs whole), its output gathered back;
    * the time axis: the input's samples are gathered at entry and the
      render runs replicated; the parameters take no extra reduction.

    A stage whose processor takes a ``noise_key`` runs whole (its noise
    is drawn over the stage's full row shape), and over the batch axis on
    the gathered batch, so a sharded render equals the single-device one
    on the same ``rng``.  The input holds :func:`local_shard`'s rows (with
    ``even=False``, uneven node shares); the parameters are whole on every
    rank.  ``jit`` as for :func:`shard_render_step`.  The executor
    (``render_grafx``) runs as it is, on wrapped processors.
    """
    mesh, spec = sharding.mesh, sharding.spec

    def axes(ndim):
        if ndim not in (3, 4):
            raise ValueError(f"input_signals has {ndim} dims; expected 3 or 4.")
        if len(spec) > ndim:
            raise ValueError(f"{spec} has more entries than the input's {ndim} dims")
        full = list(spec) + [None] * (ndim - len(spec))
        batch = full[0] if ndim == 4 else None
        node, channel, time = full[-3:]
        if channel is not None:
            raise ValueError("the channel axis cannot be sharded")
        return batch, node, time

    groups = {a: mesh.get_group(a) for a in spec if a is not None}

    @functools.cache
    def wrapped(ndim):
        batch, node, _ = axes(ndim)
        return {
            t: _WholeStage(p, groups.get(batch)) if accepts_noise_key(p)
            else _SplitStage(p, groups[node]) if node is not None
            else p
            for t, p in processors.items()
        }

    def render(x, per_type_parameters, common_parameters=None, rng=None, return_buffer=False):
        ndim = x.dim()
        batch, node, time = axes(ndim)
        if time is not None:
            x = _gather(x, ndim - 1, x.shape[-1] * dist.get_world_size(groups[time]),
                        groups[time])
        if node is not None:
            x = _gather(x, ndim - 3, render_data.iter_list[0].dest_write.num_rows, groups[node])

        def run(x, params, common):
            return render_grafx(wrapped(ndim), x, params, render_data,
                                common_parameters=common, rng=rng, return_buffer=return_buffer)

        if batch is None:
            return run(x, per_type_parameters, common_parameters)
        group = groups[batch]
        params = tree_map(lambda p: _reduce_grad(p, group), per_type_parameters)
        if common_parameters is not None:
            common_parameters = tree_map(lambda p: _reduce_grad(p, group), common_parameters)
        return _gather_outputs(run(x, params, common_parameters), group, mean=False)

    return _compiled(render, list(groups.values()), jit and render_data.method != "one-by-one",
                     "make_sharded_render_fn")


__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "batch_node_sharding",
    "batch_sharding",
    "local_shard",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_render_fn",
    "node_sharding",
    "replicated",
    "shard_render_step",
    "shares",
    "time_sharding",
]
