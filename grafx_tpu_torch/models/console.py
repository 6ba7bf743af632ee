"""Graph factories for common console topologies (the port of
:mod:`grafx_tpu.models.console`: :func:`simple_chain`,
:func:`mixing_console`, :func:`mastering_chain`), and the ~100-node mixing
console of ``bench.py``, ready to serve (:func:`bench_console`) and to
train (:func:`bench_trainer`), on the card unless ``device="cpu"`` is
asked for.

Each factory returns ``(G, processors)`` ready for
``reorder_for_fast_render`` -> ``prepare_render`` ->
``create_empty_parameters`` -> ``make_render_fn``, or for
:class:`~grafx_tpu_torch.models.optimize.GraphParameterOptimizer`.

``bench.py`` imports JAX, so its graph and processors are copied here
(``bench.py:53-95,122-130``).  The serving parameters are made on the
UNFUSED graph and migrated with :func:`fuse_parameters`, so the chains
that have no gate keep their padded gate absent (``bench.py`` draws its
parameters on the fused graph, which makes every padded gate present).
Both entry points take another processor set of the same types; the
documented swap is ``{**bench_processors(), "compressor":
FactorizedCompressor(frame_len=1024)}`` (BASELINE.md, "documented fast
path").
"""

from dataclasses import dataclass

import torch

from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor
from grafx_tpu_torch.models.optimize import GraphParameterOptimizer
from grafx_tpu_torch.ops.losses import mse_loss
from grafx_tpu_torch.processors import (
    Compressor,
    GraphicEqualizer,
    MultitapDelay,
    NoiseGate,
    ParametricEqualizer,
    STFTMaskedNoiseReverb,
    StereoGain,
    TanhDistortion,
)
from grafx_tpu_torch.render import (
    fuse_parameters,
    fuse_serial_lti,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import check_device, create_empty_parameters, tree_to


def simple_chain(chain=("eq", "compressor", "gain"), backend="exact", ir_len=30000):
    """One source through a serial chain: the reference's minimal demo."""
    processors = _default_processors(backend=backend, ir_len=ir_len)
    G = GRAFX(config=NodeConfigs(sorted(processors)))
    G.add_serial_chain(["in", *chain, "out"])
    return G, {k: v for k, v in processors.items() if k in set(chain)}


def mixing_console(
    num_tracks=8,
    track_chain=("eq", "compressor", "gain"),
    bus_chain=("geq", "compressor"),
    reverb_send=True,
    backend="exact",
    ir_len=30000,
):
    """A music-mixing console: per-track chains summed into a processed
    bus, with an optional shared reverb send (the paper's ~100-node
    benchmark topology at ``num_tracks~=16``)."""
    processors = _default_processors(backend=backend, ir_len=ir_len)
    G = GRAFX(config=NodeConfigs(sorted(processors)))

    ends = [G.add_serial_chain(["in", *track_chain])[1] for _ in range(num_tracks)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)

    first, bus_end = G.add_serial_chain(list(bus_chain))
    G.connect(mix, first)

    master = G.add("mix")
    G.connect(bus_end, master)
    if reverb_send:
        rev = G.add("reverb")
        G.connect(bus_end, rev)
        G.connect(rev, master)
    out = G.add("out")
    G.connect(master, out)

    used = set(track_chain) | set(bus_chain) | ({"reverb"} if reverb_send else set())
    return G, {k: v for k, v in processors.items() if k in used}


def mastering_chain(backend="exact"):
    """A stereo mastering chain: EQ -> multiband-ish GEQ -> compressor ->
    saturation -> gain."""
    processors = _default_processors(backend=backend)
    G = GRAFX(config=NodeConfigs(sorted(processors)))
    chain = ["in", "eq", "geq", "compressor", "dist", "gain", "out"]
    G.add_serial_chain(chain)
    used = set(chain) - {"in", "out"}
    return G, {k: v for k, v in processors.items() if k in used}


def _default_processors(backend="exact", ir_len=30000):
    return {
        "eq": ParametricEqualizer(num_filters=6, backend=backend),
        "geq": GraphicEqualizer(scale="bark", backend=backend),
        "compressor": Compressor(energy_smoother="ballistics"),
        "noisegate": NoiseGate(energy_smoother="iir"),
        "gain": StereoGain(),
        "dist": TanhDistortion(),
        "reverb": STFTMaskedNoiseReverb(ir_len=ir_len),
        "delay": MultitapDelay(segment_len=1500, num_segments=10),
    }


def bench_graph(num_chains=17):
    """Per-source chains (eq -> [geq] -> [gate] -> compressor -> gain ->
    [dist]), two processed buses, a reverb send and a master chain."""
    config = NodeConfigs(
        ["eq", "geq", "compressor", "noisegate", "gain", "dist", "reverb"]
    )
    G = GRAFX(config=config)
    chain_ends = []
    for i in range(num_chains):
        chain = ["in", "eq", "compressor", "gain"]
        if i % 3 == 0:
            chain.insert(2, "noisegate")
        if i % 4 == 0:
            chain.append("dist")
        if i % 2 == 0:
            chain.insert(2, "geq")
        _, last = G.add_serial_chain(chain)
        chain_ends.append(last)

    bus_ends = []
    for half in (chain_ends[: num_chains // 2], chain_ends[num_chains // 2 :]):
        mix = G.add("mix")
        for e in half:
            G.connect(e, mix)
        bus_first, bus_end = G.add_serial_chain(["geq", "compressor"])
        G.connect(mix, bus_first)
        bus_ends.append(bus_end)

    send_mix = G.add("mix")
    for e in bus_ends:
        G.connect(e, send_mix)
    rev = G.add("reverb")
    G.connect(send_mix, rev)

    master = G.add("mix")
    for e in bus_ends:
        G.connect(e, master)
    G.connect(rev, master)
    master_first, master_end = G.add_serial_chain(["eq", "gain"])
    G.connect(master, master_first)
    out = G.add("out")
    G.connect(master_end, out)
    return G


def bench_processors(backend="exact"):
    """``bench.py``'s processors; ``backend`` is the equalizers' IIR
    backend (``"fsm"``, the reference's default, makes every eq and geq an
    FIR-LTI node, and serial eq -> geq and eq -> gain runs fold into
    ``FusedFIRChain``s)."""
    return {
        "eq": ParametricEqualizer(num_filters=6, backend=backend),
        "geq": GraphicEqualizer(scale="bark", backend=backend),
        "compressor": Compressor(energy_smoother="ballistics"),
        "noisegate": NoiseGate(energy_smoother="iir_exact"),
        "gain": StereoGain(),
        "dist": TanhDistortion(),
        "reverb": STFTMaskedNoiseReverb(ir_len=30000),
    }


@dataclass
class Console:
    """The console as served: ``render = make_render_fn(
    console.fused_processors, console.plan)`` then ``render(x,
    console.params)`` for ``x`` of shape ``(B, num_chains, 2, L)``."""

    graph: GRAFX
    processors: dict
    fused_graph: GRAFX
    fused_processors: dict
    plan: object
    params: dict
    num_chains: int


def bench_trainer(num_chains=17, seed=0, device="cuda", processors=None, jit=True):
    """The gradient step ``bench.py`` times (``bench.py:188-197``) as a
    :class:`GraphParameterOptimizer`: the console fused with
    ``"pad-auto"``, MSE loss, SGD with lr 1e-3, and parameters drawn from
    ``seed`` on the unfused graph and migrated (so the padded gates stay
    absent, and frozen).  ``processors`` defaults to
    :func:`bench_processors`; ``jit`` as for the optimizer (the step
    replays a CUDA graph on the card).  ``bench_trainer(c, s).params``
    equal ``bench_console(c, s).params``."""
    return GraphParameterOptimizer(
        bench_graph(num_chains),
        bench_processors() if processors is None else processors,
        loss_fn=mse_loss,
        optimizer=lambda params: torch.optim.SGD(params, lr=1e-3),
        generator=torch.Generator().manual_seed(seed),
        fuse="pad-auto",
        device=device,
        jit=jit,
    )


def bench_console(num_chains=17, seed=0, device="cuda", processors=None):
    """Build the ``bench.py`` console, fused as ``bench.py`` fuses it
    (``kinds=("fir", "iir", "dynamics")``, ``dynamics_pad="auto"``), with
    random serving parameters drawn from ``seed`` by
    ``create_empty_parameters`` and everything on ``device``.
    ``processors`` defaults to :func:`bench_processors`."""
    device = check_device(device)
    G = bench_graph(num_chains)
    processors = bench_processors() if processors is None else processors
    G_fused, processors_fused = fuse_serial_lti(
        G, processors, kinds=("fir", "iir", "dynamics"), dynamics_pad="auto"
    )
    generator = torch.Generator().manual_seed(seed)
    params = create_empty_parameters(processors, G, generator=generator)
    params_fused = fuse_parameters(params, G, G_fused, processors_fused)
    plan = prepare_render(
        reorder_for_fast_render(convert_to_tensor(G_fused), method="beam")
    )
    for proc in processors_fused.values():
        proc.to(device)
    return Console(
        graph=G,
        processors=processors,
        fused_graph=G_fused,
        fused_processors=processors_fused,
        plan=plan,
        params=tree_to(params_fused, device),
        num_chains=num_chains,
    )
