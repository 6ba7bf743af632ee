"""Serial-run fusion: a graph pass that folds serial runs of fusable
processors into one operator (the port of :mod:`grafx_tpu.render.fuse`;
the rationale and measurements live there).

* **IIR** — exact-backend biquad cascades compose by concatenating their
  section stacks (:class:`FusedBiquadChain`).
* **Dynamics** — compressors / gates share one channel energy and thread
  gain products (:class:`FusedDynamicsChain`); which op serves a run is
  :mod:`grafx_tpu_torch.processors.dynamics`' choice (a gate ->
  compressor pair runs both recursions in one walk over time).
* **FIR** — FIR-LTI processors (gains, delays, reverbs, zero-phase EQs,
  fsm-backend biquad cascades, containers of such) compose their impulse
  responses by short convolutions, and the chain applies ONE
  shift-cropped convolution to the audio (:class:`FusedFIRChain`).  For
  members with zero-phase lookahead (``shift > 0``) the fused chain is
  the ideal LTI composition: it equals the per-node render of the signal
  zero-padded at the start (see :mod:`grafx_tpu.render.fuse`).

Use::

    G2, processors2 = fuse_serial_lti(G, processors, dynamics_pad="auto")
    params2 = fuse_parameters(params, G, G2, processors2)

Fused nodes get a composite type ``"fused(a+b+...)"`` whose parameters
nest per member position (``"0_a"``, ``"1_b"``, ...).
"""

import numpy as np
import torch
from torch import nn

from grafx_tpu_torch import profiling
from grafx_tpu_torch.data.configs import UTILITY_TYPES, NodeConfigs
from grafx_tpu_torch.data.graph import GRAFX
from grafx_tpu_torch.ops.fftconv import conv_stream_apply, conv_stream_init, fft_convolve
from grafx_tpu_torch.processors.core.iir import IIRFilter
from grafx_tpu_torch.processors.core.utils import accepts_noise_key, lti_kind_of
from grafx_tpu_torch.processors.dynamics import dynamics_gain, dynamics_gain_stream, gain_op
from grafx_tpu_torch.random import fold_in
from grafx_tpu_torch.render.order.graph import compute_render_order
from grafx_tpu_torch.render.order.tensor import node_id_from_render_order
from grafx_tpu_torch.utils import tree_leaves, tree_map


class _FusedChain(nn.Module):
    """Holds the ``[(name, processor), ...]`` members of a fused run."""

    def __init__(self, named_processors):
        super().__init__()
        self.members = list(named_processors)
        # registered so that .to(device) reaches the members' buffers
        self.member_modules = nn.ModuleList(p for _, p in self.members)

    def parameter_size(self):
        return {name: proc.parameter_size() for name, proc in self.members}


def _member_kernels(members, nested_params, noise_key=None):
    """``[(name, h, shift, aux), ...]``: the FIR-LTI kernel of each of the
    ``[(name, processor), ...]`` members.  Member ``i`` whose
    ``fir_kernel`` takes a ``noise_key`` gets ``fold_in(noise_key, i)``."""
    kernels = []
    for i, (name, proc) in enumerate(members):
        kw = dict(nested_params[name])
        if noise_key is not None and accepts_noise_key(proc.fir_kernel):
            kw["noise_key"] = fold_in(noise_key, i)
        kernels.append((name, *proc.fir_kernel(**kw)))
    return kernels


def _compose(kernels):
    """One ``(h, shift, intermediates)`` kernel from
    :func:`_member_kernels`' list: IRs convolve, shifts add, aux dicts
    nest by member name."""
    h, shift, intermediates = None, 0, {}
    for name, hi, si, aux in kernels:
        shift += si
        if aux:
            intermediates[name] = aux
        if h is None:
            h = hi
        else:
            h_len = h.shape[-1] + hi.shape[-1] - 1
            h = fft_convolve(h, hi, mode="full")[..., :h_len]
    return h, shift, intermediates


def compose_fir_kernels(members, nested_params, noise_key=None):
    """Compose ``[(name, processor), ...]`` FIR-LTI members into one
    ``(h, shift, intermediates)`` kernel: IRs convolve, shifts add, aux
    dicts nest by member name (shared by :class:`FusedFIRChain`'s stream
    and the containers' FIR capability).  Member ``i`` whose
    ``fir_kernel`` takes a ``noise_key`` gets ``fold_in(noise_key, i)``."""
    return _compose(_member_kernels(members, nested_params, noise_key))


def compose_biquad_kernels(members, nested_params):
    """Concatenate ``[(name, processor), ...]`` IIR-cascade members into
    one ``(Bs, As, post_gain)`` section stack."""
    Bs_list, As_list = [], []
    gain = None
    for name, proc in members:
        Bs, As, g = proc.biquad_kernel(**nested_params[name])
        Bs_list.append(Bs)
        As_list.append(As)
        if g is not None:
            gain = g if gain is None else gain * g
    B = Bs_list[0].shape[0]
    C = max(b.shape[1] for b in Bs_list)

    def cat(parts):
        return torch.cat([p.expand((B, C) + p.shape[2:]) for p in parts], dim=2)

    return cat(Bs_list), cat(As_list), gain


class FusedFIRChain(_FusedChain):
    """A fused serial run of FIR-LTI processors: the members' IRs compose
    (short convolutions), then ONE shift-cropped convolution touches the
    audio.  Members' aux losses (a delay's ``radii_reg``) are merged and
    re-emitted.

    The run's leading one-tap members (gains) scale the input, as the
    unfused nodes do, instead of being convolved into the IR, which would
    round every tap of it; a render and a stream alike
    (:func:`_leading_gains`).  So a gain -> delay run renders as its
    nodes do, to the bit; composed, the last bits would differ even where
    the output is silent, which a log-spectral loss's gradient magnifies."""

    def forward(self, input_signals, noise_key=None, **nested_params):
        kernels = _member_kernels(self.members, nested_params, noise_key)
        gains, (h, shift, _) = _leading_gains(kernels)
        out = _scaled(input_signals, gains)
        if h is not None:
            out = fft_convolve(out, h, mode=("shift", shift))
        intermediates = {name: aux for name, _, _, aux in kernels if aux}
        return (out, intermediates) if intermediates else out

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, noise_key=None, **nested_params):
        """Compose the IR of the members after the leading gains once and
        stream its one convolution (an overlap-add tail, or UPOLS for a
        long IR).  A chain with zero-phase members (``shift > 0``) needs
        lookahead and raises."""
        gains, (h, shift, _) = _leading_gains(_member_kernels(self.members, nested_params, noise_key))
        if shift:
            raise NotImplementedError(
                f"fused chain has {shift} samples of zero-phase lookahead;"
                " block-wise streaming supports causal chains only."
            )
        if h is None:
            return None, {"gains": gains, "conv": None}
        state, conv = conv_stream_init(h, num_channels, block_len)
        return state, {"gains": gains, "conv": conv}

    def stream_step(self, x, state, cache):
        x = _scaled(x, cache["gains"])
        if cache["conv"] is None:
            return x, state
        return conv_stream_apply(x, state, cache["conv"])


def _leading_gains(kernels):
    """``(gains, (h, shift, intermediates))`` from :func:`_member_kernels`'
    list: the IRs of the leading one-tap members with no shift (gains),
    which scale the signal, and the rest composed (:func:`_compose`; ``h``
    is None where nothing is left)."""
    lead = 0
    while lead < len(kernels) and kernels[lead][1].shape[-1] == 1 and kernels[lead][2] == 0:
        lead += 1
    return [h for _, h, _, _ in kernels[:lead]], _compose(kernels[lead:])


def _scaled(x, gains):
    for g in gains:
        x = x * g
    return x


def _member_block_sizes(proc):
    """Exact-backend block sizes used inside ``proc`` (recursing into
    containers, so that a fused chain adopts the largest member block)."""
    bq = getattr(proc, "biquad", None)
    if bq is not None and getattr(bq, "exact_block_size", None):
        return [bq.exact_block_size]
    inner = getattr(proc, "processors", None)
    if isinstance(inner, dict):
        return [b for p in inner.values() for b in _member_block_sizes(p)]
    return []


class FusedBiquadChain(_FusedChain):
    """A fused serial run of exact-backend biquad-cascade processors:
    the members' coefficient stacks concatenate along the section axis
    and the chain runs through ONE blocked exact-cascade apply; member
    post-gains multiply into one output gain."""

    def __init__(self, named_processors):
        super().__init__(named_processors)
        blocks = [b for _, p in self.members for b in _member_block_sizes(p)]
        self.biquad = IIRFilter(
            order=2, backend="exact",
            exact_block_size=max(blocks) if blocks else 128,
        )

    def precompute(self, **nested_params):
        """``precompute`` hook: one kernel build for the whole chain."""
        Bs, As, gain = compose_biquad_kernels(self.members, nested_params)
        cache = dict(self.biquad.precompute(Bs, As))
        if gain is not None:
            cache["post_gain"] = gain
        return cache

    @staticmethod
    def _split(cache):
        return {k: v for k, v in cache.items() if k != "post_gain"}, cache.get("post_gain")

    def forward(self, input_signals, _cache=None, **nested_params):
        if _cache is None:
            _cache = self.precompute(**nested_params)
        iir_cache, gain = self._split(_cache)
        y = self.biquad(input_signals, cache=iir_cache)
        if gain is not None:
            y = gain[..., None] * y
        return y

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, **nested_params):
        cache = self.precompute(**nested_params)
        iir_cache, _ = self._split(cache)
        return self.biquad.stream_zero_state(iir_cache, num_channels, block_len), cache

    def stream_step(self, x, state, cache):
        iir_cache, gain = self._split(cache)
        y, state = self.biquad.stream(x, state, iir_cache)
        if gain is not None:
            y = gain[..., None] * y
        return y, state


class FusedDynamicsChain(_FusedChain):
    """A fused serial run of compressors / noise gates.  A dynamics
    node's effect is ``y = gain(mean(x^2, ch)) * x``, and
    ``mean((g x)^2, ch) == g^2 mean(x^2, ch)``, so a run needs the channel
    energy once and touches the signal once with the product of gains.

    Which op computes the run's gain (the pair walk, the dynamics chain,
    or the members' own ops composed) is decided once, from the members'
    configurations, by :func:`~grafx_tpu_torch.processors.dynamics.gain_op`
    and held as :attr:`gain_op`; :func:`~grafx_tpu_torch.processors.
    dynamics.dynamics_gain` and its stream counterpart compute it.

    Padding (``fuse_serial_lti(dynamics_pad=...)``): the per-node
    ``_absent`` parameter ``(N, k)`` (> 0.5 = absent) marks a missing
    member, whose gain is then exactly 1.
    """

    def __init__(self, named_processors):
        super().__init__(named_processors)
        #: the op that serves the run, decided once from the configuration
        self.gain_op = gain_op([proc for _, proc in self.members])

    def forward(self, input_signals, **nested_params):
        energy = torch.mean(torch.square(input_signals), dim=-2)
        members = [(proc, nested_params[name]) for name, proc in self.members]
        gain = dynamics_gain(self.gain_op, members, energy, nested_params.get("_absent"))
        return gain[:, None, :] * input_signals

    # -- streaming -----------------------------------------------------

    def stream_init(self, num_channels, block_len, **nested_params):
        """Streaming contract: carry every member's smoother state; a
        block runs the dynamics chain op where ``forward`` does (it takes
        and returns each walk's state), else composes the members' gains
        (the pair walk does not return its final envelopes)."""
        states, caches = {}, {}
        for name, proc in self.members:
            states[name], caches[name] = proc.stream_init(
                num_channels, block_len, **nested_params[name]
            )
        if "_absent" in nested_params:
            caches["_absent"] = nested_params["_absent"]
        return states, caches

    def stream_step(self, x, state, cache):
        energy = torch.mean(torch.square(x), dim=-2)
        names = [name for name, _ in self.members]
        gain, states = dynamics_gain_stream(
            self.gain_op, [(proc, cache[name]) for name, proc in self.members], energy,
            [state[name] for name in names], cache.get("_absent"),
        )
        return gain[:, None, :] * x, dict(zip(names, states))

    def parameter_size(self):
        sizes = super().parameter_size()
        # per-node member-presence mask (>0.5 = absent); structural, not
        # trainable (see grafx_tpu.render.fuse.FusedDynamicsChain)
        sizes["_absent"] = len(self.members)
        return sizes


_FUSED_CLASS = {
    "fir": FusedFIRChain,
    "iir": FusedBiquadChain,
    "dynamics": FusedDynamicsChain,
}


def _lti_kind(node_type, processors):
    """``"fir"`` / ``"iir"`` / ``"dynamics"`` / ``None`` for a node type."""
    if node_type in UTILITY_TYPES:
        return None
    proc = processors.get(node_type)
    k = lti_kind_of(proc)
    if k is None and getattr(proc, "dynamics_fusable", False):
        k = "dynamics"
    return k


def fuse_serial_fir(G, processors, min_run=2):
    """Fold maximal serial runs of FIR-LTI nodes: the ``kinds=("fir",)``
    slice of :func:`fuse_serial_lti`, kept as the original entry point."""
    return fuse_serial_lti(G, processors, min_run=min_run, kinds=("fir",))


@profiling.setup_spanned("grafx.plan.fuse")
def fuse_serial_lti(
    G,
    processors,
    min_run=2,
    kinds=("fir", "iir", "dynamics"),
    dynamics_partial=False,
    dynamics_pad=False,
    _pad_exclude=frozenset(),
):
    """Rewrite ``G``, folding maximal serial runs of same-kind fusable
    nodes (see :func:`grafx_tpu.render.fuse.fuse_serial_lti` for the
    full contract).

    Args:
        G: a :class:`GRAFX` graph (unscheduled).
        processors: node-type -> processor dict.
        min_run: minimum run length to fold (default 2).
        kinds: which fusion families to apply.
        dynamics_partial: fuse dynamics runs even when they cover only
            part of a member type's nodes (splitting its render stage).
        dynamics_pad: lone nodes of a member type of some 2-member
            dynamics pattern join that composite type with the other
            member marked absent.  ``"auto"`` additionally demotes
            composite stages that hold only padded lone nodes back to
            their plain type (their pair walk would merge nothing).
        _pad_exclude: internal (``"auto"``): node ids never to pad.

    Returns:
        ``(G_fused, processors_fused)``.  Migrate parameters made for
        ``G`` with :func:`fuse_parameters`.
    """
    if dynamics_pad == "auto":
        exclude = frozenset(_pad_exclude)
        for _ in range(1 + len(G.nodes)):  # fixed point; bounded
            G2, P2 = fuse_serial_lti(
                G,
                processors,
                min_run=min_run,
                kinds=kinds,
                dynamics_partial=dynamics_partial,
                dynamics_pad=True,
                _pad_exclude=exclude,
            )
            new = exclude | _padded_only_stage_nodes(G2)
            if new == exclude:
                return G2, P2
            exclude = new
        return G2, P2

    # --- find runs ------------------------------------------------------
    def kind_of(node):
        k = _lti_kind(G.nodes[node]["node_type"], processors)
        return k if k in kinds else None

    in_run = set()
    runs = []  # [(kind, [nodes...], type sequence), ...]
    for n in sorted(G.nodes):
        if n in in_run:
            continue
        k = kind_of(n)
        if k is None:
            continue
        # start a run only at a node whose predecessor cannot extend it
        preds = list(G.predecessors(n))
        if (
            len(preds) == 1
            and G.out_degree(preds[0]) == 1
            and G.in_degree(n) == 1
            and kind_of(preds[0]) == k
        ):
            continue
        run = [n]
        cur = n
        while True:
            succs = list(G.successors(cur))
            if len(succs) != 1 or G.out_degree(cur) != 1:
                break
            nxt = succs[0]
            if G.in_degree(nxt) != 1 or kind_of(nxt) != k:
                break
            run.append(nxt)
            cur = nxt
        if len(run) >= min_run:
            seq = tuple(G.nodes[m]["node_type"] for m in run)
            runs.append((k, run, seq))
            in_run.update(run)

    if dynamics_pad:
        patterns = []
        for k, run, seq in runs:
            if k == "dynamics" and len(seq) == 2 and seq not in patterns:
                patterns.append(seq)
        pad_exempt = set()
        for seq in patterns:
            for pos, t in enumerate(seq):
                for n in sorted(G.nodes):
                    if (
                        n in in_run
                        or G.nodes[n]["node_type"] != t
                        or kind_of(n) != "dynamics"
                    ):
                        continue
                    if n in _pad_exclude:
                        pad_exempt.add(n)
                        continue
                    padded = [None, None]
                    padded[pos] = n
                    runs.append(("dynamics", padded, seq))
                    in_run.add(n)
    else:
        pad_exempt = set(_pad_exclude)

    if not dynamics_partial:
        # Dynamics-coverage guard: keep dynamics runs only when every node
        # of every member type is inside a run (or pad-exempt), so fusion
        # removes stages instead of splitting them.
        total = {}
        for n in G.nodes:
            t = G.nodes[n]["node_type"]
            total[t] = total.get(t, 0) + 1
        covered = {}
        for k, run, seq in runs:
            if k != "dynamics":
                continue
            for n in run:
                if n is not None:
                    t = G.nodes[n]["node_type"]
                    covered[t] = covered.get(t, 0) + 1
        for n in pad_exempt:
            t = G.nodes[n]["node_type"]
            covered[t] = covered.get(t, 0) + 1
        kept = []
        for k, run, seq in runs:
            if k == "dynamics" and any(
                covered.get(t, 0) < total[t] for t in set(seq)
            ):
                in_run.difference_update(n for n in run if n is not None)
                continue
            kept.append((k, run, seq))
        runs = kept

    if not runs:
        return G, dict(processors)

    # --- composite types ------------------------------------------------
    processors_fused = dict(processors)
    run_type = {}
    for k, run, seq in runs:
        if seq not in run_type:
            fused_name = "fused(" + "+".join(seq) + ")"
            run_type[seq] = fused_name
            processors_fused[fused_name] = _FUSED_CLASS[k](
                [(f"{i}_{t}", processors[t]) for i, t in enumerate(seq)]
            )

    # --- rebuild the graph ---------------------------------------------
    base_defs = {
        t: G.config.node_type_dict[t]
        for t in G.config.node_types
        if t not in UTILITY_TYPES
    }
    for fused_name in sorted(run_type.values()):
        base_defs[fused_name] = {"inlets": ["main"], "outlets": ["main"]}
    G2 = GRAFX(config=NodeConfigs(base_defs), invalid_op=G.invalid_op)

    node_map = {}  # old node -> new node carrying its output
    for _, run, seq in runs:
        fused = G2.add(run_type[seq])
        for n in run:
            if n is not None:
                node_map[n] = fused
    for n in sorted(G.nodes):
        if n not in node_map:
            node_map[n] = G2.add(G.nodes[n]["node_type"])

    interior = {
        (run[i], run[i + 1])
        for _, run, _seq in runs
        for i in range(len(run) - 1)
    }
    for u, v, data in G.edges(data=True):
        if (u, v) in interior:
            continue
        outlet = data.get("outlet", "main") if u not in in_run else "main"
        inlet = data.get("inlet", "main") if v not in in_run else "main"
        G2.connect(node_map[u], node_map[v], outlet=outlet, inlet=inlet)

    # node provenance for fuse_parameters: new composite node -> its
    # run's original nodes (member order); new plain node -> [original]
    fused_from = {}
    for _, run, _seq in runs:
        first = next(n for n in run if n is not None)
        fused_from[node_map[first]] = list(run)
    for n, n2 in node_map.items():
        if n2 not in fused_from:
            fused_from[n2] = [n]
    G2.graph["fused_from"] = fused_from
    return G2, processors_fused


def _padded_only_stage_nodes(G_fused, method="beam", **order_kwargs):
    """Original-graph node ids whose padded composite stage holds NO
    genuine run (the ``dynamics_pad="auto"`` demotion criterion)."""
    fused_from = G_fused.graph.get("fused_from", {})
    _, render_order = compute_render_order(G_fused, method=method, **order_kwargs)
    stages = {}
    for n, order in zip(sorted(G_fused.nodes), render_order):
        t = G_fused.nodes[n]["node_type"]
        if t.startswith("fused("):
            stages.setdefault((int(order), t), []).append(n)
    demote = set()
    for members in stages.values():
        srcs = [fused_from.get(m, [m]) for m in members]
        if all(any(s is None for s in src) for src in srcs):
            for src in srcs:
                demote.update(s for s in src if s is not None)
    return demote


def _scheduled_type_rows(G, method, **order_kwargs):
    """Within-type parameter row of every node of ``G`` under the
    scheduled (``reorder_for_fast_render``) node order."""
    _, render_order = compute_render_order(G, method=method, **order_kwargs)
    new_id = np.asarray(node_id_from_render_order(render_order))
    nodes = sorted(G.nodes)  # convert_to_tensor's node enumeration
    rows = {}
    counts = {}
    for idx in np.argsort(new_id):
        n = nodes[idx]
        t = G.nodes[n]["node_type"]
        rows[n] = counts.get(t, 0)
        counts[t] = rows[n] + 1
    return rows


@profiling.setup_spanned("grafx.plan.migrate")
def fuse_parameters(params, G, G_fused, processors_fused, method="beam", **order_kwargs):
    """Migrate per-type parameters from ``G`` to its fused rewrite.

    Parameter rows bind to nodes by their within-type order in the
    scheduled tensor; fusion moves run members under composite types.
    This re-gathers every leaf row so that parameters made for ``G``
    render identically on ``G_fused``.  Padded composite nodes get
    zero rows for the missing member and ``_absent = 1`` in its column.

    Args:
        params: type -> parameter dict for ``G``.
        G: the original graph.
        G_fused, processors_fused: the output of :func:`fuse_serial_lti`.
        method: the scheduling method used with both graphs.
        **order_kwargs: the scheduler's own arguments (a beam's
            ``width``/``depth``, ``fixed_order``), as passed to
            ``reorder_for_fast_render``.
    """
    fused_from = G_fused.graph.get("fused_from")
    if fused_from is None:
        if G_fused is G:
            return params
        raise ValueError(
            "G_fused carries no fusion provenance; pass the graph"
            " returned by fuse_serial_lti."
        )

    orig_row = _scheduled_type_rows(G, method, **order_kwargs)
    fused_row = _scheduled_type_rows(G_fused, method, **order_kwargs)

    def gather(tree, rows):
        return tree_map(lambda a: a[torch.as_tensor(rows, device=a.device)], tree)

    out = {}
    for t2, proc in processors_fused.items():
        nodes2 = sorted(
            (n for n in G_fused.nodes if G_fused.nodes[n]["node_type"] == t2),
            key=lambda n: fused_row[n],
        )
        if not nodes2:
            continue
        if t2.startswith("fused(") and hasattr(proc, "members"):
            nested = {}
            absent = np.zeros((len(nodes2), len(proc.members)), np.float32)
            device = None
            for i, (mname, _) in enumerate(proc.members):
                t_orig = mname.split("_", 1)[1]
                srcs = [fused_from[n2][i] for n2 in nodes2]
                rows = [orig_row[s] if s is not None else 0 for s in srcs]
                sub = gather(params[t_orig], rows)
                if any(s is None for s in srcs):
                    keep = np.array([0.0 if s is None else 1.0 for s in srcs], np.float32)
                    sub = tree_map(
                        lambda a: a * torch.as_tensor(keep, device=a.device).reshape(
                            (-1,) + (1,) * (a.dim() - 1)
                        ),
                        sub,
                    )
                    absent[:, i] = 1.0 - keep
                nested[mname] = sub
                device = next((leaf.device for leaf in tree_leaves(sub)), device)
            if "_absent" in proc.parameter_size():
                nested["_absent"] = torch.as_tensor(absent, device=device)
            out[t2] = nested
        elif t2 in params:
            rows = [orig_row[fused_from[n2][0]] for n2 in nodes2]
            out[t2] = gather(params[t2], rows)
    return out
