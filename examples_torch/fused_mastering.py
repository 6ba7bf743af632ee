"""LTI-chain fusion on the port: a mastering-style graph, fused and unfused.

Seventeen parallel mastering chains (low-shelf -> peaking -> high-shelf
-> low-pass -> gain) are rewritten by the graph pass ``fuse_serial_lti``
(``grafx_tpu_torch/render/fuse.py``): each chain's four serial
exact-cascade filters fold into ONE ``FusedBiquadChain``, one blocked
apply in place of four.  The script checks that the two graphs render the
same output, then times a full gradient step of each, captured as one
CUDA graph on the card.

Run:  python examples_torch/fused_mastering.py [--audio-len 131072] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from examples_torch._common import add_device_argument, timed_ms  # noqa: E402
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor  # noqa: E402
from grafx_tpu_torch.processors import (  # noqa: E402
    HighShelf,
    LowPassFilter,
    LowShelf,
    PeakingFilter,
    StereoGain,
)
from grafx_tpu_torch.render import (  # noqa: E402
    CapturedFunction,
    fuse_serial_lti,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import check_device, create_empty_parameters, tree_leaves, tree_map  # noqa: E402

NUM_CHAINS = 17
REL = 1e-4  # fused against unfused: max abs <= REL x max|unfused|


def build():
    procs = {
        "ls": LowShelf(backend="exact"),
        "pk": PeakingFilter(backend="exact"),
        "hs": HighShelf(backend="exact"),
        "lp": LowPassFilter(backend="exact"),
        "gain": StereoGain(),
    }
    G = GRAFX(config=NodeConfigs(list(procs)))
    ends = []
    for _ in range(NUM_CHAINS):
        _, last = G.add_serial_chain(["in", "ls", "pk", "hs", "lp", "gain"])
        ends.append(last)
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    return G, procs


def fused_parameters(params, procs_fused):
    """The unfused per-type parameters in the fused nesting: each member
    ``"<i>_<type>"`` of the fused chain takes its type's rows."""
    fused_name = next(t for t in procs_fused if t.startswith("fused("))
    out = {fused_name: {n: params[n.split("_", 1)[1]] for n, _ in procs_fused[fused_name].members}}
    for t in procs_fused:
        if not t.startswith("fused(") and t in params:
            out[t] = params[t]
    return out


def prepare(G, procs, device):
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    for proc in procs.values():
        proc.to(device)
    return plan


def make_step(procs, plan, params, x):
    """One SGD step (lr 1e-3) on ``mean(render(x) ** 2)``, updating
    ``params`` in place; on the card the whole update replays one CUDA
    graph (the first call runs eagerly, the second captures)."""
    render = make_render_fn(procs, plan, jit=False)  # differentiated inside the step
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=1e-3)

    def update(signals):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean(render(signals, params)[0] ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    step = CapturedFunction(update, name="fused_mastering step")
    return lambda: step(x)


def time_step(step, device, iters=20):
    """Mean ms of ``iters`` steps, after two warm ones (the eager call
    and the capture)."""
    step()
    step()
    ms, _ = timed_ms(lambda: [step() for _ in range(iters)], device)
    return ms / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--audio-len", type=int, default=2**17)
    ap.add_argument("--batch", type=int, default=4)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    print(f"device: {device}")

    G, procs = build()
    G2, procs2 = fuse_serial_lti(G, procs)
    fused_types = sorted(t for t in procs2 if t.startswith("fused("))
    print(f"graph: {G.number_of_nodes()} nodes -> {G2.number_of_nodes()}"
          f" after fusion; composite types: {fused_types}")

    plan_u, plan_f = prepare(G, procs, device), prepare(G2, procs2, device)
    params_u = create_empty_parameters(procs, G, generator=torch.Generator().manual_seed(0),
                                       device=device)
    params_u = tree_map(lambda v: v + 0.1, params_u)
    params_f = fused_parameters(params_u, procs2)
    x = torch.randn(args.batch, NUM_CHAINS, 2, args.audio_len,
                    generator=torch.Generator().manual_seed(1)).to(device)

    with torch.no_grad():
        y_u = make_render_fn(procs, plan_u)(x, params_u)[0]
        y_f = make_render_fn(procs2, plan_f)(x, params_f)[0]
    rel = float((y_f - y_u).abs().max() / (y_u.abs().max() + 1e-9))
    print(f"fused-vs-unfused output relative error: {rel:.2e}")
    assert rel < REL

    # each step trains its own copy of the parameters
    step_u = make_step(procs, plan_u, tree_map(torch.clone, params_u), x)
    step_f = make_step(procs2, plan_f, tree_map(torch.clone, params_f), x)
    ms_u = time_step(step_u, device)
    ms_f = time_step(step_f, device)
    print(f"unfused grad step: {ms_u:.3f} ms")
    print(f"fused grad step:   {ms_f:.3f} ms  ({ms_u / ms_f:.2f}x)")
    return {"nodes": G.number_of_nodes(), "fused_nodes": G2.number_of_nodes(),
            "fused_types": fused_types, "rel": rel, "unfused_ms": ms_u, "fused_ms": ms_f,
            "speedup": ms_u / ms_f}


if __name__ == "__main__":
    main()
