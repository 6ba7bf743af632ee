"""Graph-level batching: union a list of graphs into one disconnected graph.

The port of :mod:`grafx_tpu.data.batch` (reference:
src/grafx/data/batch.py:4-37): node ids are offset per graph, ``counter``
becomes a cumulative per-graph list, and all graphs must share the same
config hash and consecutive ids.
"""

from grafx_tpu_torch.data._multigraph import relabel_nodes, union_all


def batch_grafx(G_list):
    """Batch a list of :class:`GRAFX` graphs into one disconnected graph."""
    counters, counter = [], 0
    new_G_list = []
    config_hash = None
    for i, G in enumerate(G_list):
        if not G.consecutive_ids:
            raise ValueError("The node ids must be consecutive.")
        if G.batch:
            raise ValueError(f"Graph of index {i} is already a batched graph.")
        if i == 0:
            config_hash = G.config_hash
        elif config_hash != G.config_hash:
            raise ValueError("Graphs with different node configs cannot be batched.")
        if i != 0:
            mapping = {j: j + counter for j in range(G.number_of_nodes())}
            G = relabel_nodes(G, mapping)
        new_G_list.append(G)
        counter += G.counter
        counters.append(counter)

    G_batch = union_all(new_G_list)
    G_batch.counter = counters
    G_batch.batch = True
    return G_batch
