"""Immutable tensor form of an audio graph.

Behavioral parity with the reference ``GRAFXTensor``
(reference: src/grafx/data/tensor.py:10-103), but numpy-backed: the tensor
form is a host-side artifact — schedules and render plans are computed
from it on the CPU and read by the render executor as static indices, so
nothing here moves to a device.
"""

from dataclasses import dataclass, replace
from typing import Optional, Union

import numpy as np

from grafx_tpu_torch.data.configs import NodeConfigs


@dataclass
class GRAFXTensor:
    """Array-form graph: node types, edge indices, and schedule metadata.

    Args:
        node_types: ``(|V|,)`` int array of node-type indices.
        edge_indices: ``(2, |E|)`` int array ``[sources; dests]``.
        counter: node counter (or per-graph cumulative list when batched).
        batch: whether this is a batched (disconnected-union) graph.
        config: the :class:`NodeConfigs`.
        config_hash: hash of the config.
        invalid_op: invalid-operation policy string.
        edge_types: ``(|E|, 2)`` outlet/inlet indices (MIMO only).
        rendering_order_method / rendering_orders / type_sequence: schedule
            metadata filled in by ``reorder_for_fast_render``.
    """

    node_types: np.ndarray
    edge_indices: np.ndarray
    counter: Union[int, list]
    batch: bool
    config: NodeConfigs
    config_hash: int
    invalid_op: str

    edge_types: Optional[np.ndarray] = None
    rendering_order_method: Optional[str] = None
    rendering_orders: Optional[np.ndarray] = None
    type_sequence: Optional[list] = None

    @property
    def num_nodes(self):
        return len(self.node_types)

    @property
    def num_edges(self):
        return self.edge_indices.shape[1]

    def replace(self, **changes):
        """Functional update (the tensor form is treated as immutable)."""
        return replace(self, **changes)

    def to(self, device=None):
        """API-familiarity no-op (reference: data/tensor.py:92-103): the
        tensor form stays on the host."""
        return self

    def __str__(self):
        parts = []
        for k, v in self.__dict__.items():
            s = str(list(v.shape)) if isinstance(v, np.ndarray) else repr(v)
            parts.append(f"\n  {k}={s}")
        return f"GRAFXTensor({', '.join(parts)}\n)"
