"""The plain render of a configuration's graph, node by node, unfused.

A node's input is the sum of its predecessors' outputs; ``in`` nodes are
the stems, ``mix`` and ``out`` nodes pass the sum on, and a processor node
runs its type's module of this package (``reference/<Class>.py``).  Nodes
of one type that are ready together run as one batch of rows (each with
its own parameters), which changes nothing in the result.

Every array carries an item axis ``R`` (a request or a step, each with its
own parameters) and a mix axis ``B`` before the node's own: stems are
``(R, B, S, C, L)`` and the parameters of type ``t`` are
``{name: (R, rows of t, *size)}``, row ``i`` bound to the node
``rows[t][i]``.
"""

import importlib

import torch

UTILITY = ("in", "out", "mix")


def module(class_name):
    """The reference module of a processor class."""
    return importlib.import_module(f"portbench.reference.{class_name}")


def schedule(nodes, edges):
    """Batches ``[(type, [node, ...])]`` in an order every edge respects:
    a type runs when all its pending nodes are ready, else the type with
    the most ready nodes runs those."""
    preds = {n: [] for n in range(len(nodes))}
    for s, d in edges:
        preds[d].append(s)
    pending, done, out = set(preds), set(), []
    while pending:
        ready = {}
        for n in sorted(pending):
            if all(p in done for p in preds[n]):
                ready.setdefault(nodes[n], []).append(n)
        left = {}
        for n in pending:
            left[nodes[n]] = left.get(nodes[n], 0) + 1
        whole = [t for t, ns in ready.items() if len(ns) == left[t]]
        kind = whole[0] if whole else max(ready, key=lambda t: len(ready[t]))
        out.append((kind, ready[kind]))
        pending -= set(ready[kind])
        done |= set(ready[kind])
    return out, preds


def render(config, stems, params, rows, ctx, outs=None):
    """The ``(R, B, C, L)`` output of the graph's ``out`` node (``outs``:
    a dict that receives every node's output).

    ``rows``: ``{type: [node id of row 0, ...]}`` (``"in"``: the stem of
    each ``in`` node); ``ctx.rnd`` rounds every node's input, output and
    parameters (the identity but in a bfloat16 control)."""
    nodes, procs = config["nodes"], config["processors"]
    batches, preds = schedule(nodes, config["edges"])
    row_of = {t: {n: i for i, n in enumerate(ns)} for t, ns in rows.items()}
    outs = {} if outs is None else outs
    result = None
    for kind, batch in batches:
        if kind == "in":
            for n in batch:
                outs[n] = ctx.rnd(stems[:, :, row_of["in"][n]])
            continue
        inputs = []
        for n in batch:
            x = None
            for p in preds[n]:
                x = outs[p] if x is None else x + outs[p]
            inputs.append(x)
        if kind in UTILITY:
            for n, x in zip(batch, inputs):
                outs[n] = x
            if kind == "out":
                result = inputs[0]
            continue
        spec = procs[kind]
        x = ctx.rnd(torch.stack(inputs))  # (k, R, B, C, L)
        k, R, B = x.shape[:3]
        idx = torch.as_tensor([row_of[kind][n] for n in batch], device=x.device)
        p = {}
        for name, value in params[kind].items():
            v = ctx.rnd(value.index_select(1, idx).transpose(0, 1))  # (k, R, *size)
            v = v[:, :, None].expand((k, R, B) + v.shape[2:])
            p[name] = v.reshape((k * R * B,) + v.shape[3:])
        y = module(spec["class"]).render(x.reshape((k * R * B,) + x.shape[3:]), p,
                                         spec["args"], ctx)
        y = ctx.rnd(y).reshape((k, R, B) + y.shape[1:])
        for i, n in enumerate(batch):
            outs[n] = y[i]
    return result


def count(config, batch, length, train):
    """``(flops, walk_bytes)`` of one request (``train``: one step) of
    ``batch`` mixes, by the reference modules' counts; a step counts its
    backward as twice its forward."""
    flops = walk = 0
    channels = config["channels"]
    types = config["nodes"]
    _, preds = schedule(types, config["edges"])
    for n, kind in enumerate(types):
        if kind in ("mix", "out"):
            flops += max(len(preds[n]) - 1, 0) * batch * channels * length
            continue
        if kind == "in":
            continue
        spec = config["processors"][kind]
        mod = module(spec["class"])
        flops += mod.flops(batch, channels, length, spec["args"])
        if hasattr(mod, "walk_bytes"):
            walk += mod.walk_bytes(batch, length, train)
    if train:
        flops = 3 * flops + 3 * batch * channels * length  # backward, the loss
    return flops, walk
