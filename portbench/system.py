"""The system under test, built from a configuration through
``grafx_tpu_torch``'s public API: the graph and processors, the served
render and the trainer, and the map between the benchmark's parameters
(one row per node of the unfused graph) and the program's."""

import copy

import torch


def processors(config):
    from grafx_tpu_torch import processors as procs

    return {t: getattr(procs, s["class"])(**s["args"]) for t, s in config["processors"].items()}


def graph(config):
    from grafx_tpu_torch.data import GRAFX, NodeConfigs

    G = GRAFX(config=NodeConfigs(config["node_types"]))
    for kind in config["nodes"]:
        G.add(kind)
    for s, d in config["edges"]:
        G.connect(s, d)
    return G


def row_nodes(G):
    """``{type: [node id of each parameter row]}``: the port binds a type's
    parameter rows (and an ``in`` node's stem) to its nodes in their
    scheduled order (``reorder_for_fast_render``, beam)."""
    from grafx_tpu_torch.render import reorder_for_fast_render

    H = copy.deepcopy(G)
    for n in H.nodes:
        H.nodes[n]["portbench_id"] = n
    H = reorder_for_fast_render(H, method="beam")
    rows = {}
    for n in sorted(H.nodes):
        rows.setdefault(H.nodes[n]["node_type"], []).append(H.nodes[n]["portbench_id"])
    return rows


def check_sizes(procs, sizes):
    """Raise unless the program takes the parameters the reference draws."""
    def norm(v):
        return (v,) if isinstance(v, int) else tuple(v)

    for t, proc in procs.items():
        have = {k: norm(v) for k, v in proc.parameter_size().items()}
        if have != sizes[t]:
            raise ValueError(f"{t}: the program takes {have}, the reference {sizes[t]}")


class Served:
    """``make_render_fn(fused processors, plan, jit=True)`` of the fused
    console; :meth:`__call__` renders ``(B, S, C, L)`` stems with unfused
    parameters already migrated by :meth:`migrate`."""

    def __init__(self, config, traffic, device):
        from grafx_tpu_torch.data import convert_to_tensor
        from grafx_tpu_torch.render import (
            fuse_serial_lti,
            make_render_fn,
            prepare_render,
            reorder_for_fast_render,
        )

        self.G = graph(config)
        self.procs = processors(config)
        fuse = traffic["fuse"]
        self.G_fused, self.procs_fused = fuse_serial_lti(
            self.G, self.procs, kinds=tuple(fuse["kinds"]), dynamics_pad=fuse["dynamics_pad"])
        plan = prepare_render(reorder_for_fast_render(convert_to_tensor(self.G_fused), method="beam"))
        for proc in self.procs_fused.values():
            proc.to(device)
        self.render = make_render_fn(self.procs_fused, plan, jit=True)

    def migrate(self, params):
        from grafx_tpu_torch.render import fuse_parameters

        return fuse_parameters(params, self.G, self.G_fused, self.procs_fused)

    def __call__(self, x, fused_params):
        """The ``(B, C, L)`` mixes (the render's one ``out`` node)."""
        return self.render(x, fused_params)[0][:, 0]


class Trainer:
    """``GraphParameterOptimizer`` of the console (``fuse``, MSE, SGD) with
    the benchmark's parameters copied into it before its first step."""

    def __init__(self, config, traffic, device):
        from grafx_tpu_torch.models.optimize import GraphParameterOptimizer
        from grafx_tpu_torch.ops.losses import mse_loss

        if traffic["loss"] != "mse" or traffic["optimizer"]["name"] != "sgd":
            raise NotImplementedError("the trainer runs MSE and SGD")
        lr = traffic["optimizer"]["lr"]
        self.G = graph(config)
        self.procs = processors(config)
        self.opt = GraphParameterOptimizer(
            self.G, self.procs, loss_fn=mse_loss,
            optimizer=lambda ps: torch.optim.SGD(ps, lr=lr),
            generator=torch.Generator().manual_seed(0),
            fuse=traffic["fuse"], device=device, jit=True)

    def load(self, params):
        """Copy unfused parameters into the optimizer's, in place."""
        from grafx_tpu_torch.render import fuse_parameters
        from grafx_tpu_torch.utils import tree_items

        fused = fuse_parameters(params, self.G, self.opt.G, self.opt.processors)
        live, new = tree_items(self.opt.params), tree_items(fused)
        if [k for k, _ in live] != [k for k, _ in new]:
            raise ValueError("the migrated parameters do not match the optimizer's")
        with torch.no_grad():
            for (_, p), (_, v) in zip(live, new):
                p.copy_(v)

    def step(self, x, target):
        return self.opt.step(x, target)[1]

    def leaf_sums(self, fn):
        """``{(type, name): sum of squares of fn(path, p)}`` over the live
        parameters, by the unfused graph's types: a fused type's member
        ``i_<type>`` adds to ``<type>``; member masks are left out."""
        from grafx_tpu_torch.utils import tree_items

        out = {}
        for path, p in tree_items(self.opt.params):
            parts = path.split("/")
            if parts[-2] == "_absent" or parts[-1] == "_absent":
                continue
            key = (parts[1].split("_", 1)[1], parts[2]) if len(parts) == 3 else tuple(parts)
            v = fn(path, p)
            if v is not None:
                out[key] = out.get(key, 0.0) + float(torch.sum(v.detach().double() ** 2))
        return out

    def snapshot(self):
        from grafx_tpu_torch.utils import tree_items

        return {path: p.detach().clone() for path, p in tree_items(self.opt.params)}
