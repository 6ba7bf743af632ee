"""Render-plan compiler: graph tensor -> static render plan.

Behavioral parity with the reference ``prepare_render``
(reference: src/grafx/render/prepare.py:93-244), copied from
:mod:`grafx_tpu.render.prepare` (numpy only).  Every read/write index in
the plan is a static Python int / numpy array computed on the host.

Access compression: consecutive index lists become ``("slice", lo, hi)``
(a tensor view, no copy), everything else a gather.  Aggregation classification picks ``none`` / ``sum`` /
``scatter`` per stage-inlet; a ``scatter`` carries its :class:`SegmentSum`
plan, from which the executor sums each segment's rows in a fixed order
(no atomics, so a render on the card repeats bit for bit).

One deliberate fix vs the reference: the MIMO path reads each edge's own
outlet/inlet pair (the reference indexes ``edge_types`` with the stage
counter — prepare.py:150 — a latent bug) and the buffer row count is the
total number of *outlets*, not nodes.
"""

import functools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TensorAccess:
    """A static read/write pattern: ``none``, ``slice`` (lo, hi), or
    ``index`` (gather rows)."""

    method: str  # "none" | "slice" | "index"
    idx: Optional[Tuple] = None  # (lo, hi) for slice; tuple of ints for index

    def __str__(self):
        return f"{self.method} with {self.idx}"

    @property
    def num_rows(self):
        if self.method == "none":
            return 0
        if self.method == "slice":
            return self.idx[1] - self.idx[0]
        return len(self.idx)


@dataclass(frozen=True)
class SegmentSum:
    """A static plan for summing rows into segments in a fixed order,
    made once from each row's segment ``idx`` (the backward's gather
    index):

    * ``run``: ``k`` where segment ``s`` is rows ``[s k, (s + 1) k)`` for
      every ``s`` (the sorted case of ``grafx_tpu/render/core.py:102``
      with equal runs), else 0;
    * ``filled``: the segments that have rows, ascending; the others
      stay zero;
    * ``slots``: each row's place in a zero ``(len(filled), width)``
      grid, row-major: its segment's place in ``filled``, then its rank
      among that segment's rows in the order of ``idx``.
    """

    idx: Tuple[int, ...]
    num_segments: int
    run: int
    filled: Tuple[int, ...]
    width: int
    slots: Tuple[int, ...]


@functools.cache
def plan_segment_sum(idx, num_segments):
    """The :class:`SegmentSum` of rows ``idx`` (a tuple: row ``r`` goes to
    segment ``idx[r]``) into ``num_segments`` segments."""
    counts = [0] * num_segments
    for r, s in enumerate(idx):
        if not 0 <= s < num_segments:
            raise ValueError(f"Segment {s} of row {r} is outside [0, {num_segments})")
        counts[s] += 1
    filled = tuple(s for s, n in enumerate(counts) if n)
    width = max(counts, default=0)
    k = len(idx) // num_segments if num_segments else 0
    run = k if k and idx == tuple(r // k for r in range(len(idx))) else 0
    grid_row = {s: i for i, s in enumerate(filled)}
    rank = [0] * num_segments
    slots = []
    for s in idx:
        slots.append(grid_row[s] * width + rank[s])
        rank[s] += 1
    return SegmentSum(idx, num_segments, run, filled, width, tuple(slots))


@dataclass(frozen=True)
class Aggregation:
    """Fan-in handling: ``none`` (1:1), ``sum`` (all into one node), or
    ``scatter`` (general fan-in via segment-sum, planned in
    ``segments``)."""

    method: str  # "none" | "sum" | "scatter"
    idx: Optional[Tuple] = None
    num_segments: int = 0

    @property
    def segments(self):
        """A ``scatter``'s :class:`SegmentSum` (planned once per ``idx``
        and count, when the render plan is made)."""
        return plan_segment_sum(self.idx, self.num_segments)

    def __str__(self):
        if self.method == "scatter":
            return f"scatter with {self.idx}"
        return self.method


@dataclass(frozen=True)
class RenderStage:
    """One type-homogeneous stage of the render plan."""

    node_type: str
    source_reads: Tuple[TensorAccess, ...]
    aggregations: Tuple[Aggregation, ...]
    parameter_read: TensorAccess
    dest_write: TensorAccess

    def __str__(self):
        lines = [f"- Node type: {self.node_type}"]
        if len(self.source_reads) == 1:
            lines.append(f"- Source read: {self.source_reads[0]}")
        else:
            lines.append("- Source reads:")
            lines += [f"  * {r}" for r in self.source_reads]
        if len(self.aggregations) == 1:
            lines.append(f"- Aggregation: {self.aggregations[0]}")
        else:
            lines.append("- Aggregations:")
            lines += [f"  * {a}" for a in self.aggregations]
        lines.append(f"- Parameter read: {self.parameter_read}")
        lines.append(f"- Dest write: {self.dest_write}")
        return "\n".join(lines)


@dataclass(frozen=True)
class RenderData:
    """The full static render plan.

    Attributes:
        method: scheduling method used.
        num_nodes: number of graph nodes.
        num_buffers: signal-buffer rows (== num_nodes for SISO; total
            outlet count for MIMO).
        max_order: last stage index.
        siso_only: whether the config is SISO-only.
        iter_list: per-stage :class:`RenderStage` entries (index 0 is the
            input stage and is skipped by the executor).
    """

    method: str
    num_nodes: int
    num_buffers: int
    max_order: int
    siso_only: bool
    iter_list: Tuple[RenderStage, ...] = field(default=())

    def __str__(self):
        out = [
            f"Rendering of {self.num_nodes} nodes with siso_only:"
            f" {self.siso_only}."
        ]
        for i, it in enumerate(self.iter_list):
            out.append(f"Render #{i}\n{it}")
        return "\n\n".join(out)


def check_and_convert_arange(idx):
    """Compress an index list to a slice when consecutive
    (reference: prepare.py:218-228)."""
    idx = [int(v) for v in idx]
    if len(idx) == 0:
        return TensorAccess(method="none", idx=())
    if all(b - a == 1 for a, b in zip(idx, idx[1:])):
        return TensorAccess(method="slice", idx=(idx[0], idx[-1] + 1))
    return TensorAccess(method="index", idx=tuple(idx))


def check_aggregate_method(scatter_idx, node_list):
    """Pick none / sum / scatter for a stage's fan-in
    (reference: prepare.py:198-215)."""
    scatter_idx = [int(v) for v in scatter_idx]
    n = len(node_list)
    if len(scatter_idx) == 0:
        return Aggregation(method="none")
    if len(scatter_idx) == 1 and scatter_idx[0] == 0 and n == 1:
        return Aggregation(method="none")
    if all(v == 0 for v in scatter_idx) and n == 1:
        return Aggregation(method="sum")
    if (
        len(scatter_idx) == n
        and scatter_idx[0] == 0
        and all(b - a == 1 for a, b in zip(scatter_idx, scatter_idx[1:]))
    ):
        return Aggregation(method="none")
    aggregation = Aggregation(method="scatter", idx=tuple(scatter_idx), num_segments=n)
    aggregation.segments  # planned (and its indices checked) with the render plan
    return aggregation


def create_per_type_indices(node_types):
    """Position of each node within its type — its parameter row
    (reference: prepare.py:237-244)."""
    node_types = np.asarray(node_types)
    out = np.zeros_like(node_types)
    for t in set(node_types.tolist()):
        mask = node_types == t
        out[mask] = np.arange(mask.sum())
    return out


def prepare_render(G_t):
    """Compile the per-stage read/aggregate/process/write metadata for a
    scheduled tensor graph (reference: prepare.py:93-195)."""
    configs = G_t.config
    method = G_t.rendering_order_method
    siso_only = configs.siso_only
    type_sequence = G_t.type_sequence
    if method is None or G_t.rendering_orders is None:
        raise ValueError(
            "Graph must be scheduled first (reorder_for_fast_render)."
        )

    node_types = np.asarray(G_t.node_types)
    rendering_orders = np.asarray(G_t.rendering_orders)
    per_type_indices = create_per_type_indices(node_types)

    # sort edges by destination for per-stage lookup
    E = np.asarray(G_t.edge_indices)
    order = np.argsort(E[1], kind="stable")
    E = E[:, order]
    if not siso_only:
        edge_types = np.asarray(G_t.edge_types)[order]
        num_outlets_per_node = np.array(
            [configs.num_outlets[configs.node_types[t]] for t in node_types]
        )
        buffer_offsets = np.concatenate(
            [[0], np.cumsum(num_outlets_per_node)[:-1]]
        )
        num_buffers = int(num_outlets_per_node.sum())
    else:
        num_buffers = len(node_types)

    max_order = int(rendering_orders.max())
    dests = E[1]

    iter_list = []
    for i in range(max_order + 1):
        node_mask = rendering_orders == i
        node_idxs = np.where(node_mask)[0]
        node_list = node_idxs.tolist()
        node_pos = {n: j for j, n in enumerate(node_list)}
        node_type = type_sequence[i]

        edge_mask = np.isin(dests, node_idxs)
        edges = E[:, edge_mask].T  # (num_in_edges, 2)

        if siso_only:
            source_idx = [int(s) for s, _ in edges]
            scatter_idx = [node_pos[int(d)] for _, d in edges]
            source_reads = (check_and_convert_arange(source_idx),)
            aggregations = (check_aggregate_method(scatter_idx, node_list),)
        else:
            num_inlets = configs.num_inlets[node_type]
            source_idxs = [[] for _ in range(max(num_inlets, 1))]
            scatter_idxs = [[] for _ in range(max(num_inlets, 1))]
            stage_edge_types = edge_types[edge_mask]
            for (s, d), (outlet, inlet) in zip(edges, stage_edge_types):
                scatter_idxs[inlet].append(node_pos[int(d)])
                source_idxs[inlet].append(int(buffer_offsets[s]) + int(outlet))
            source_reads = tuple(
                check_and_convert_arange(idx) for idx in source_idxs
            )
            aggregations = tuple(
                check_aggregate_method(idx, node_list) for idx in scatter_idxs
            )

        parameter_read = check_and_convert_arange(
            per_type_indices[node_mask].tolist()
        )

        if siso_only:
            buffer_idx = node_list
        else:
            n_out = configs.num_outlets[node_type]
            buffer_idx = []
            for idx in node_list:
                off = int(buffer_offsets[idx])
                buffer_idx += list(range(off, off + n_out))
        dest_write = check_and_convert_arange(buffer_idx)

        iter_list.append(
            RenderStage(
                node_type=node_type,
                source_reads=source_reads,
                aggregations=aggregations,
                parameter_read=parameter_read,
                dest_write=dest_write,
            )
        )

    return RenderData(
        method=method,
        num_nodes=len(node_types),
        num_buffers=num_buffers,
        max_order=max_order,
        siso_only=siso_only,
        iter_list=tuple(iter_list),
    )
