"""Stream the 100-node mixing console block by block on the port.

The streaming renderer (``grafx_tpu_torch.render.StreamRenderer``) runs
the same static render plan as the one-shot render, one audio block at a
time with carried per-node state: exact IIR filter states, compressor and
gate envelopes, reverb convolution tails.  The console is ``bench.py``'s
graph (its copy in ``grafx_tpu_torch/models/console.py``), unfused.  On
the card each block step replays one captured CUDA graph.

Prints (a) the streamed output against the one-shot render and (b) the
real-time factor (audio seconds processed per second) at the block size,
then the same with ``step_many``'s k blocks per call.

Run: python examples_torch/streaming_console.py [block_len] [--device cpu]  (default 4096)
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from examples_torch._common import add_device_argument, timed_ms  # noqa: E402
from grafx_tpu_torch.data import convert_to_tensor  # noqa: E402
from grafx_tpu_torch.models.console import bench_graph, bench_processors  # noqa: E402
from grafx_tpu_torch.render import (  # noqa: E402
    StreamRenderer,
    make_render_fn,
    prepare_render,
    reorder_for_fast_render,
)
from grafx_tpu_torch.utils import check_device, create_empty_parameters  # noqa: E402

NUM_CHAINS, SR = 17, 44100  # bench.py's
AUDIO_LEN = 2**17
REPEATS = 3  # passes over the signal timed


def db(err, scale):
    return 20 * math.log10(err / scale + 1e-12)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("block_len", type=int, nargs="?", default=4096)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    block_len = args.block_len

    G = bench_graph(NUM_CHAINS)
    # eq and geq on the exact IIR backend, the compressors on the
    # ballistics smoother, the gates on the exact one-pole IIR, and the
    # STFT-masked noise reverb of 30000 taps: bench.py's processors
    processors = bench_processors()
    for proc in processors.values():
        proc.to(device)
    plan = prepare_render(reorder_for_fast_render(convert_to_tensor(G), method="beam"))
    params = create_empty_parameters(processors, G, generator=torch.Generator().manual_seed(0),
                                     device=device)
    x = torch.randn(NUM_CHAINS, 2, AUDIO_LEN, generator=torch.Generator().manual_seed(1)).to(device)
    n_blocks = AUDIO_LEN // block_len
    blocks = list(x[..., : n_blocks * block_len].split(block_len, dim=-1))

    with torch.no_grad():
        # one-shot reference
        full = make_render_fn(processors, plan)(x, params)[0]

        # streamed (the first block runs eagerly, the second captures)
        streamer = StreamRenderer(processors, plan, params, block_len=block_len)
        state, outs = streamer.init_state(), []
        for xb in blocks:
            y, state = streamer(xb, state)
            outs.append(y)
        streamed = torch.cat(outs, dim=-1)
        full = full[..., : n_blocks * block_len]
        scale = full.abs().max().item() + 1e-9
        err_rel = (streamed - full).abs().max().item() / scale
        print(f"streamed vs one-shot: max error {db(err_rel, 1.0):.1f} dB re peak")

        # timed streaming loop (steady state: every block a replay)
        def loop():
            s = streamer.init_state()
            for _ in range(REPEATS):
                for xb in blocks:
                    _, s = streamer(xb, s)

        ms, _ = timed_ms(loop, device)
        reps = REPEATS * n_blocks
        block_ms = ms / reps
        rtf = (reps * block_len / SR) / (ms / 1e3)
        print(f"block {block_len} ({block_len / SR * 1000:.1f} ms of audio):"
              f" {block_ms:.3f} ms/block -> RTF {rtf:.1f}x real time"
              f" ({G.number_of_nodes()}-node console, {NUM_CHAINS} sources, device {device})")
        result = {"nodes": G.number_of_nodes(), "blocks": n_blocks, "block_len": block_len,
                  "err_rel": err_rel, "err_db": db(err_rel, 1.0), "block_ms": block_ms, "rtf": rtf,
                  "step_many": {},
                  "compressor_stages": sum(s.node_type == "compressor" for s in plan.iter_list),
                  "gate_stages": sum(s.node_type == "noisegate" for s in plan.iter_list)}

        # k blocks a call (step_many): one replay for k blocks; latency k blocks
        for k_blocks in (4, 16):
            if n_blocks % k_blocks:
                continue
            groups = torch.stack(blocks).reshape(
                n_blocks // k_blocks, k_blocks, NUM_CHAINS, 2, block_len)
            state, outs = streamer.init_state(), []
            for g in groups:  # the first group runs eagerly, the second captures
                yb, state = streamer.step_many(g, state)
                outs.append(yb)
            many = torch.cat(outs).permute(1, 2, 0, 3).reshape(full.shape)
            err_k = (many - full).abs().max().item() / scale

            def loop_many():
                s = streamer.init_state()
                for _ in range(REPEATS):
                    for g in groups:
                        _, s = streamer.step_many(g, s)

            ms, _ = timed_ms(loop_many, device)
            rtf_k = (reps * block_len / SR) / (ms / 1e3)
            print(f"step_many k={k_blocks} ({k_blocks * block_len / SR * 1000:.0f}"
                  f" ms latency): {ms / reps:.3f} ms/block -> RTF {rtf_k:.1f}x real time"
                  f" (parity {db(err_k, 1.0):.1f} dB)")
            result["step_many"][k_blocks] = {"err_rel": err_k, "block_ms": ms / reps, "rtf": rtf_k}
    return result


if __name__ == "__main__":
    main()
