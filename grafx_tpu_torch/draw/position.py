"""Node layout: chain/level estimation and longest-path ranks
(reference: src/grafx/draw/position.py:5-143).  The topological order is
``networkx.topological_sort``'s (:func:`~grafx_tpu_torch.data._multigraph.
topological_sort`), so the positions equal ``grafx_tpu``'s."""

from grafx_tpu_torch.data._multigraph import topological_sort


def estimate_chain(G):
    """Group nodes into 'chains' rooted at sources; merge points start new
    chains at a deeper level.  Returns sorted (level, chain, preds)."""
    levels_and_chains = []
    for node_idx in topological_sort(G):
        if G.in_degree(node_idx) == 0:
            G.nodes[node_idx]["chain"] = node_idx
            G.nodes[node_idx]["level"] = 0
            levels_and_chains.append((0, node_idx, []))
        else:
            pchains, plevels = [], []
            for n in G.predecessors(node_idx):
                if "chain" in G.nodes[n]:
                    pchains.append(G.nodes[n]["chain"])
                    plevels.append(G.nodes[n]["level"])
            pchains = sorted(set(pchains))
            if not pchains:
                continue
            if len(pchains) == 1:
                G.nodes[node_idx]["chain"] = pchains[0]
                G.nodes[node_idx]["level"] = plevels[0]
            else:
                new_level = 1 + max(plevels)
                G.nodes[node_idx]["chain"] = node_idx
                G.nodes[node_idx]["level"] = new_level
                levels_and_chains.append((new_level, node_idx, pchains))
    return sorted(levels_and_chains, key=lambda t: (t[0], t[1]))


def compute_rank(G):
    """Rank = longest-path depth from the sources; source-less utility
    nodes fall back to (min successor rank - 1)."""
    levels_and_chains = estimate_chain(G)
    chains = [t[1] for t in levels_and_chains]
    G_sorted = list(topological_sort(G))

    rank_dict = {k: {} for k in chains}
    deferred = []
    for node_idx in G_sorted:
        pranks = [G.nodes[n]["rank"] for n in G.predecessors(node_idx)]
        if G.in_degree(node_idx) == 0:
            rank = 0
        else:
            rank = max(pranks) + 1 if pranks else -1
        G.nodes[node_idx]["rank"] = rank
        if rank == -1:
            deferred.append(node_idx)
        elif "chain" in G.nodes[node_idx]:
            rank_dict[G.nodes[node_idx]["chain"]].setdefault(rank, []).append(
                node_idx
            )
    for node_idx in deferred:
        sranks = [G.nodes[n]["rank"] for n in G.successors(node_idx)]
        rank = min(sranks) - 1 if sranks else 0
        G.nodes[node_idx]["rank"] = rank
        if "chain" in G.nodes[node_idx]:
            rank_dict[G.nodes[node_idx]["chain"]].setdefault(rank, []).append(
                node_idx
            )

    rank_dict = {k: v for k, v in rank_dict.items() if v}
    return G_sorted, rank_dict, levels_and_chains


def compute_node_position(G, node_spacing=(0.8, 0.8)):
    """Assign ``x0``/``y0`` to every node: x from rank, y from per-chain
    offsets stacked by level."""
    _, rank_dict, levels_and_chains = compute_rank(G)

    max_rel = {k: 0 for k in rank_dict}
    for chain, ranks in rank_dict.items():
        for rank, node_idxs in ranks.items():
            for rel, node_idx in enumerate(sorted(node_idxs)):
                G.nodes[node_idx]["relative_y0"] = rel
                max_rel[chain] = max(max_rel[chain], rel)

    y0_offset, y0_min, y0_max = {}, {}, {}
    c = 0
    for level, chain, predecessors in levels_and_chains:
        if level != 0:
            lo = min(y0_min[p] for p in predecessors)
            hi = max(y0_max[p] for p in predecessors)
            y0_min[chain], y0_max[chain] = lo, hi
            y0_offset[chain] = (lo + hi) / 2
        else:
            y0_offset[chain] = c
            y0_min[chain] = c
            y0_max[chain] = c
            c += 1 + max_rel.get(chain, 0)

    for idx, node in G.nodes(data=True):
        node["y0"] = y0_offset[node["chain"]] + node.get("relative_y0", 0)
        node["x0"] = node["rank"]

    for node_id in G.nodes:
        G.nodes[node_id]["x0"] *= node_spacing[0]
        G.nodes[node_id]["y0"] *= node_spacing[1]
