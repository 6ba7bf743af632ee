"""Type-scheduling searches over the tensor-form graph.

Behavioral parity with the reference schedulers
(reference: src/grafx/render/order/tensor.py:24-247): find a short
sequence of causal, type-homogeneous node subsets (stages).  Stage 0 is
all ``"in"`` nodes and the last stage is all ``"out"`` nodes.

Scheduling is a host-side activity: the schedule is fixed before the
render runs, so these searches run on the CPU in numpy (vectorized over
beam states).  The
frontier step is a scatter-reduce over edges, exactly the reference's
algorithm, expressed as a counting scatter-add.
"""

import numpy as np

MAX_ITER = 100

from grafx_tpu_torch.utils import permute_grafx_tensor


def return_render_ordered_tensor(G_t, method, **kwargs):
    """Schedule a tensor graph and permute node ids so same-(type, order)
    nodes are contiguous (reference: order/tensor.py:12-21)."""
    type_sequence, render_order = compute_render_order_tensor(G_t, method, **kwargs)

    G_t = G_t.replace(
        type_sequence=[G_t.config.node_types[t] for t in type_sequence],
        rendering_orders=np.asarray(render_order),
        rendering_order_method=method,
    )
    node_id = node_id_from_render_order(render_order)
    return permute_grafx_tensor(G_t, node_id)


def compute_render_order_tensor(G_t, method="beam", **kwargs):
    match method:
        case "greedy":
            return greedy_search(G_t, **kwargs)
        case "beam":
            return beam_search(G_t, **kwargs)
        case "fixed":
            return fixed_order_search(G_t, **kwargs)
        case "one-by-one":
            return one_by_one_search(G_t, **kwargs)
        case _:
            raise ValueError(f"Invalid rendering method: {method}.")


def _frontier_per_type(visited, source_ids, dest_ids, in_degree, type_masks):
    """Newly-computable nodes per type for a batch of beam states.

    Args:
        visited: ``(B, N)`` bool.
        type_masks: ``(T, N)`` bool, one row per schedulable type.

    Returns:
        ``(B, T, N)`` bool — for each state and candidate type, the nodes of
        that type whose predecessors are all visited and that are unvisited.
    """
    B, N = visited.shape
    satisfied = np.zeros((B, N), dtype=np.int64)
    if len(dest_ids):
        rows = np.arange(B)[:, None]
        np.add.at(satisfied, (rows, dest_ids[None, :]), visited[:, source_ids])
    computable = (satisfied == in_degree) & ~visited
    return computable[:, None, :] & type_masks[None, :, :]


def _schedulable_types(node_types):
    """Unique non-utility type ids present in the graph.  Type 0 (``in``)
    and 1 (``out``) are handled specially; ``mix`` (2) schedules normally."""
    uniq = sorted(set(node_types.tolist()))
    return np.array([t for t in uniq if t not in (0, 1)], dtype=np.int64)


def greedy_search(G_t):
    """Beam search with width 1 and no lookahead
    (reference: order/tensor.py:123)."""
    return beam_search(G_t, width=1, depth=1)


def beam_search(G_t, depth=1, width=64, use_native=True):
    """Beam search over type sequences: at each step, expand each beam
    state by every candidate type, score by the number of visited nodes
    after ``depth`` lookahead expansions, and keep the top ``width`` unique
    states (reference: order/tensor.py:127-230).

    With ``use_native`` the C++ search (:mod:`grafx_tpu_torch._native`,
    built at first use) runs where it can be built; otherwise, and where
    it fails (a cycle), this numpy search runs, which raises a
    descriptive error for a cycle.  Both give the same schedule.

    Returns:
        ``(type_sequence, render_order)``: the stage type indices
        (including leading 0 / trailing 1) and each node's stage index.
    """
    if use_native:
        from grafx_tpu_torch._native import beam_search_native

        result = beam_search_native(
            np.asarray(G_t.node_types), np.asarray(G_t.edge_indices), width=width, depth=depth
        )
        if result is not None:
            return result

    T = np.asarray(G_t.node_types)
    E = np.asarray(G_t.edge_indices)
    N = G_t.num_nodes
    source_ids, dest_ids = E[0], E[1]
    in_degree = np.bincount(dest_ids, minlength=N)

    types = _schedulable_types(T)
    if not ((T == 0).any() and (T == 1).any()):
        raise ValueError("graph needs 'in' and 'out' nodes")
    type_masks = T[None, :] == types[:, None]  # (T, N)

    visited = ((T == 0) | (T == 1))[None, :]  # (1, N)
    render_order = np.where(T == 0, 0, -1)[None, :]  # (1, N)
    type_sequences = [[0]]

    def lookahead_score(v, d):
        # max visited count reachable with d more type expansions
        count = v.sum(-1)
        if d == 0:
            return count
        new = _frontier_per_type(
            v.reshape(-1, N), source_ids, dest_ids, in_degree, type_masks
        ).reshape(v.shape[:-1] + (len(types), N))
        expanded = v[..., None, :] | new
        return np.maximum(count, lookahead_score(expanded, d - 1).max(-1))

    for i in range(1, MAX_ITER + 1):
        new_per_type = _frontier_per_type(
            visited, source_ids, dest_ids, in_degree, type_masks
        )  # (B, T, N)
        cand_visited = visited[:, None, :] | new_per_type  # (B, T, N)
        score = lookahead_score(cand_visited, depth - 1)  # (B, T)

        B = visited.shape[0]
        flat_score = score.reshape(-1)
        order = np.argsort(-flat_score, kind="stable")

        # dedup identical visited states, keeping the best-scoring one
        chosen, seen = [], set()
        flat_visited = cand_visited.reshape(-1, N)
        for idx in order:
            key = flat_visited[idx].tobytes()
            if key in seen:
                continue
            seen.add(key)
            chosen.append(idx)
            if len(chosen) == width:
                break
        chosen = np.array(chosen)
        prev_idx, type_idx = chosen // len(types), chosen % len(types)

        visited = flat_visited[chosen]
        render_order = render_order[prev_idx].copy()
        new_nodes = new_per_type[prev_idx, type_idx]
        render_order[new_nodes] = i
        type_sequences = [
            type_sequences[p] + [int(types[t])] for p, t in zip(prev_idx, type_idx)
        ]

        all_visited = visited.all(-1)
        if all_visited.any():
            break
        if i == MAX_ITER:
            raise RuntimeError("beam_search exceeded MAX_ITER")

    final = int(np.argmax(all_visited))
    type_sequence = np.array(type_sequences[final] + [1], dtype=np.int64)
    render_order = render_order[final]
    render_order[T == 1] = i + 1
    return type_sequence, render_order


def fixed_order_search(G_t, fixed_order):
    """Schedule with a user-supplied type sequence: at each step, take the
    next type in ``fixed_order`` that has ready nodes, and all of them
    (reference: order/tensor.py:65-120).  ``fixed_order[0]`` stands for
    the ``"in"`` stage and is skipped."""
    T = np.asarray(G_t.node_types)
    E = np.asarray(G_t.edge_indices)
    N = G_t.num_nodes
    source_ids, dest_ids = E[0], E[1]
    in_degree = np.bincount(dest_ids, minlength=N)
    types = _schedulable_types(T)
    type_masks = T[None, :] == types[:, None]

    render_order = np.where(T == 0, 0, -1)
    type_sequence = [0]
    visited = (T == 0) | (T == 1)

    i, order_i = 0, 1
    for _ in range(MAX_ITER):
        new_per_type = _frontier_per_type(
            visited[None, :], source_ids, dest_ids, in_degree, type_masks
        )[0]
        while True:
            i += 1
            if i >= len(fixed_order):
                raise RuntimeError("fixed_order exhausted before covering graph")
            t = fixed_order[i]
            t_pos = int(np.where(types == t)[0][0])
            new_nodes = new_per_type[t_pos]
            if new_nodes.any():
                visited = visited | new_nodes
                type_sequence.append(int(t))
                render_order[new_nodes] = order_i
                order_i += 1
                break
        if visited.all():
            break

    type_sequence.append(1)
    render_order[T == 1] = order_i
    return np.array(type_sequence, dtype=np.int64), render_order


def one_by_one_search(G_t):
    """Degenerate schedule: one node per stage (after a single joint
    ``in`` stage), derived from the greedy order
    (reference: order/tensor.py:39-62)."""
    g_types, g_order = greedy_search(G_t)
    render_order = -np.ones(len(g_order), dtype=np.int64)
    type_sequence = []
    i, order = 0, 0
    while True:
        mask = g_order == order
        if order == 0:
            render_order[mask] = 0
            type_sequence.append(0)
            i += 1
        else:
            num = int(mask.sum())
            if num == 0:
                break
            node_type = int(g_types[order])
            render_order[mask] = np.arange(i, i + num)
            i += num
            type_sequence += [node_type] * num
        order += 1
    return np.array(type_sequence, dtype=np.int64), render_order


def node_id_from_render_order(render_order):
    """Stable renumbering: nodes sorted by (order, old id)
    (reference: order/tensor.py:233-247)."""
    render_order = np.asarray(render_order)
    node_id = -np.ones(len(render_order), dtype=np.int64)
    i, order = 0, 0
    while True:
        mask = render_order == order
        num = int(mask.sum())
        if num == 0:
            break
        node_id[mask] = np.arange(i, i + num)
        order += 1
        i += num
    return node_id
