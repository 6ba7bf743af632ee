"""Multi-process data-parallel training on the port: two processes on
``torch.distributed``, runnable on one box.

Each process is a rank; it holds its local shard of the graph batch,
the parameters replicate, and ``grafx_tpu_torch.parallel`` gathers the
render over the ranks so that every rank's gradient is the
single-process one.  The ranks meet on a ``FileStore`` in a temporary
directory and talk over gloo.  On one card both ranks share it (NCCL
refuses two ranks on one card); ``--device cpu`` runs them on the CPU.

This script is both the launcher and the worker:

    python examples_torch/multihost_dp.py [--device cpu]   # spawns 2 ranks

Each rank:
  1. joins the group and builds a data-parallel mesh over the ranks,
  2. builds a small mixing console,
  3. cuts its rows of the global batch (every rank can make the whole,
     deterministic batch; each keeps only its own rows, as a data loader
     would),
  4. runs three SGD steps (lr 1e-2) on ``mean(y ** 2)`` through
     ``shard_render_step`` (eagerly: a gloo group on the card cannot be
     captured in a CUDA graph),
  5. rank 0 checks the resulting loss and parameters against a
     single-process run of the same steps on the whole batch.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from examples_torch._common import add_device_argument, timed_ms  # noqa: E402
from grafx_tpu_torch import parallel  # noqa: E402
from grafx_tpu_torch.data import GRAFX, NodeConfigs, convert_to_tensor  # noqa: E402
from grafx_tpu_torch.ops import ballistics  # noqa: E402
from grafx_tpu_torch.processors import Compressor, ParametricEqualizer, StereoGain  # noqa: E402
from grafx_tpu_torch.render import make_render_fn, prepare_render, reorder_for_fast_render  # noqa: E402
from grafx_tpu_torch.utils import check_device, create_empty_parameters, tree_items  # noqa: E402

NUM_PROCESSES = 2
GLOBAL_BATCH = 8
L = 2**13
STEPS, LR = 3, 1e-2
TOL = 1e-5  # rank 0's loss (relative) and parameters (max abs) against one process
TIMEOUT_S = 600


def console(device):
    """Four chains eq -> comp -> gain into one mix: ``(processors, plan,
    params)`` on ``device``."""
    procs = {
        "eq": ParametricEqualizer(num_filters=4, backend="exact"),
        "comp": Compressor(energy_smoother="ballistics"),
        "gain": StereoGain(),
    }
    for proc in procs.values():
        proc.to(device)
    G = GRAFX(config=NodeConfigs(sorted(procs)))
    ends = [G.add_serial_chain(["in", "eq", "comp", "gain"])[1] for _ in range(4)]
    mix = G.add("mix")
    for e in ends:
        G.connect(e, mix)
    G.connect(mix, G.add("out"))
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    params = create_empty_parameters(procs, G, generator=torch.Generator().manual_seed(0),
                                     device=device)
    return procs, plan, params


def sgd_steps(render, params, x):
    """Three SGD steps on ``mean(render(x) ** 2)``; returns the last loss
    and the parameters (trained in place)."""
    leaves = [v.requires_grad_(True) for _, v in tree_items(params)]
    opt = torch.optim.SGD(leaves, lr=LR)
    for _ in range(STEPS):
        opt.zero_grad()
        loss = torch.mean(render(x, params)[0] ** 2)
        loss.backward()
        opt.step()
    return loss.item(), params


def worker(rank, world, directory, device_name):
    if device_name.startswith("cuda"):
        torch.cuda.set_device(torch.device(device_name))
    device = torch.device(device_name)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(directory, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = parallel.make_mesh(device=device.type)
        procs, plan, params = console(device)
        render = make_render_fn(procs, plan, jit=False)
        x_full = torch.randn(GLOBAL_BATCH, 4, 2, L, generator=torch.Generator().manual_seed(1))
        x_local = parallel.local_shard(x_full, parallel.batch_sharding(mesh)).to(device)

        ballistics.reset_launch_counts()
        ms, (loss, params) = timed_ms(
            lambda: sgd_steps(parallel.shard_render_step(render, mesh, jit=False), params, x_local),
            device)
        result = {"rank": rank, "local_shape": list(x_local.shape), "loss": loss, "ms": ms,
                  "launches": ballistics.launch_counts(),
                  "compressor_stages": sum(s.node_type == "comp" for s in plan.iter_list)}

        if rank == 0:
            # the single-process oracle on the whole batch
            loss_ref, p_ref = sgd_steps(render, console(device)[2], x_full.to(device))
            rel = abs(loss - loss_ref) / (abs(loss_ref) + 1e-12)
            p_err = max((a - b).abs().max().item()
                        for (_, a), (_, b) in zip(tree_items(params), tree_items(p_ref)))
            print(f"[multihost] loss distributed {loss:.6f} vs single-process {loss_ref:.6f}"
                  f" (rel {rel:.2e}); max param diff {p_err:.2e}", flush=True)
            assert rel < TOL and p_err < TOL
            print("[multihost] OK: 2-process data-parallel step matches", flush=True)
            result.update(loss_ref=loss_ref, rel=rel, p_err=p_err,
                          launches_with_oracle=ballistics.launch_counts())
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    directory = tempfile.mkdtemp(prefix="grafx_multihost_")
    try:
        context = mp.start_processes(worker, args=(NUM_PROCESSES, directory, str(device)),
                                     nprocs=NUM_PROCESSES, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not context.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"multihost_dp: ranks still running after {TIMEOUT_S} s")
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
                process.join()
        ranks = []
        for rank in range(NUM_PROCESSES):
            with open(os.path.join(directory, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print("multihost_dp: all workers green")
    return {"ranks": ranks, "rel": ranks[0]["rel"], "p_err": ranks[0]["p_err"], "steps": STEPS}


if __name__ == "__main__":
    main()
