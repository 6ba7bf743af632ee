"""Neural parameter prediction: audio features -> graph parameters (the
port of :mod:`grafx_tpu.models.predictor`).

The GRAFX paper's companion use (arXiv:2408.03204) trains networks that
predict processor parameters, differentiating through the graph render.
:class:`ParameterPredictor` is an ``nn.Module`` with one MLP per
processor type, mapping per-node audio features to every parameter
tensor of that type: it returns the nested parameter dict that the
render consumes, so ``loss(render(x, predictor(features)))`` trains the
network end to end through the DSP.
"""

import numpy as np
import torch
from torch import nn

from grafx_tpu_torch.data import convert_to_tensor
from grafx_tpu_torch.ops.stft import hann_window, stft
from grafx_tpu_torch.processors.core.fft_filterbank import TriangularFilterBank
from grafx_tpu_torch.render.order import compute_render_order_tensor
from grafx_tpu_torch.utils import _int_to_tuple


def audio_features(signals, n_fft=1024, hop=512, num_bands=32, sr=44100):
    """Per-item log-mel-band energy statistics: a differentiable
    conditioning vector ``(B, 2 * num_bands)`` (mean and population
    standard deviation over time) of ``(B, C, L)`` signals."""
    window = torch.as_tensor(hann_window(n_fft), dtype=signals.dtype, device=signals.device)
    spec = torch.abs(stft(signals.mean(dim=-2), n_fft, hop, window)) ** 2  # (B, F, T)
    fb = TriangularFilterBank(
        num_frequency_bins=n_fft // 2 + 1,
        num_filters=num_bands,
        scale="mel_htk",
        f_min=40,
        f_max=sr // 2,
        sr=sr,
    ).to(signals.device, signals.dtype)
    bands = fb(spec.transpose(-1, -2), mode="analysis")  # (B, T, bands)
    log_bands = torch.log(bands + 1e-6)
    return torch.cat([log_bands.mean(-2), log_bands.std(-2, correction=0)], dim=-1)


def _render_ordered(G, method="beam"):
    """The graph's node ids by (render stage, node id): the numbering that
    ``reorder_for_fast_render`` gives, and an order in which every node
    comes after its predecessors."""
    nodes = list(G.nodes)
    _, order = compute_render_order_tensor(convert_to_tensor(G), method)
    return [nodes[i] for i in sorted(range(len(nodes)), key=lambda i: (order[i], i))]


def features_per_type(G, processors, stem_features, mix_features, method="beam"):
    """:meth:`ParameterPredictor.forward`'s input for a console: each
    node conditions on the features of the one stem that feeds it, and a
    node that several stems feed (a bus, a send) on the mix's.

    Args:
        stem_features: ``(num_sources, feature_dim)``, row ``i`` for the
            ``i``-th input signal.
        mix_features: ``(feature_dim,)``.

    Returns:
        type -> ``(num_nodes_of_type, feature_dim)``, rows in
        parameter-row order: each type's parameter rows follow the
        scheduled numbering (:func:`_render_ordered`).
    """
    ordered = _render_ordered(G, method)
    stems_of, rows = {}, {}
    for n in ordered:
        node_type = G.nodes[n]["node_type"]
        if node_type == "in":  # the i-th source node takes input signal i
            stems_of[n] = {len(rows.get("in", ()))}
        else:
            stems_of[n] = set().union(*(stems_of[p] for p in G.predecessors(n)))
        rows.setdefault(node_type, []).append(n)
    return {
        t: torch.stack([
            stem_features[next(iter(stems_of[n]))] if len(stems_of[n]) == 1 else mix_features
            for n in rows[t]
        ])
        for t in processors if t in rows
    }


class ParameterPredictor(nn.Module):
    """Per-type MLPs from feature vectors to parameter trees.

    Args:
        processors: type -> processor mapping (the output shapes come from
            each ``parameter_size()``, leaves in its dict order).
        feature_dim: conditioning vector size.
        hidden: hidden layer width.
        output_scale: predictions are squashed to ``output_scale * tanh``
            (keeps early training in the well-behaved parameter region).
        generator: CPU ``torch.Generator`` for :meth:`init` (default: seeded
            with 0).
    """

    def __init__(self, processors, feature_dim=64, hidden=128, output_scale=2.0,
                 generator=None):
        super().__init__()
        self.feature_dim = feature_dim
        self.hidden = hidden
        self.output_scale = output_scale
        self.specs = {}
        self.mlps = nn.ModuleDict()
        for t, proc in processors.items():
            leaves = []

            def collect(prefix, shapes):
                for k, v in shapes.items():
                    if isinstance(v, dict):
                        collect(prefix + (k,), v)
                    else:
                        leaves.append((prefix + (k,), _int_to_tuple(v)))

            collect((), proc.parameter_size())
            self.specs[t] = leaves
            out_dim = sum(int(np.prod(s)) for _, s in leaves)
            # skip_init: the weights are drawn by init, not from torch's global rng
            self.mlps[t] = nn.Sequential(
                nn.utils.skip_init(nn.Linear, feature_dim, hidden),
                nn.Tanh(),
                nn.utils.skip_init(nn.Linear, hidden, out_dim),
            )
        self.init(torch.Generator().manual_seed(0) if generator is None else generator)

    @torch.no_grad()
    def init(self, generator):
        """Draw the weights as ``grafx_tpu``'s ``init`` does: ``w1 ~ N(0, 1)
        / sqrt(feature_dim)`` and ``w2 ~ N(0, 1) / sqrt(hidden)`` in
        ``grafx_tpu``'s ``(in, out)`` layout, on the CPU from
        ``generator``, type by type; the biases 0."""
        for mlp in self.mlps.values():
            first, last = mlp[0], mlp[2]
            for layer in (first, last):
                w = torch.randn(layer.in_features, layer.out_features, generator=generator)
                layer.weight.copy_(w.T / np.sqrt(layer.in_features))
                layer.bias.zero_()

    @torch.no_grad()
    def load_numpy(self, weights):
        """Load ``grafx_tpu``'s ``init`` output as numpy, type -> ``{w1, b1,
        w2, b2}`` with ``w`` as ``(in, out)``, transposing into
        ``nn.Linear``'s ``(out, in)``."""
        if set(weights) != set(self.mlps):
            raise ValueError(f"weights for types {sorted(weights)}, predictor has {sorted(self.mlps)}")
        for t, mlp in self.mlps.items():
            w = weights[t]
            for layer, wk, bk in ((mlp[0], "w1", "b1"), (mlp[2], "w2", "b2")):
                layer.weight.copy_(torch.tensor(np.asarray(w[wk], dtype=np.float32)).T)
                layer.bias.copy_(torch.tensor(np.asarray(w[bk], dtype=np.float32)))

    def forward(self, features_per_type):
        """Predict the full per-type parameter tree.

        Args:
            features_per_type: type -> ``(num_nodes_of_type, feature_dim)``
                conditioning vectors (one row per node, in parameter-row
                order).

        Returns:
            The nested dict that ``render_grafx`` consumes.
        """
        out = {}
        for t, leaves in self.specs.items():
            flat = self.output_scale * torch.tanh(self.mlps[t](features_per_type[t]))
            result, offset = {}, 0
            for path, shape in leaves:
                size = int(np.prod(shape))
                node = result
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = flat[:, offset : offset + size].reshape((flat.shape[0],) + shape)
                offset += size
            out[t] = result
        return out
