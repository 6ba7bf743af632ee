"""Graph -> tensor conversion.

Behavioral parity with the reference ``convert_to_tensor``
(reference: src/grafx/data/conversion.py:8-85): relabel to consecutive ids
if needed, sort nodes and edges, map type names to indices, and build the
``(2, |E|)`` edge-index array; ``edge_types`` only for MIMO configs.
"""

import numpy as np

from grafx_tpu_torch.data._multigraph import relabel_nodes
from grafx_tpu_torch.data.tensor import GRAFXTensor


def convert_to_tensor(G):
    """Convert a :class:`GRAFX` graph into a :class:`GRAFXTensor`."""
    config = G.config
    if not G.consecutive_ids:
        G = _relabel_nodes_to_consecutive_ids(G)

    nodes_with_data = sorted(G.nodes(data=True))
    edges_with_data = sorted(G.edges(data=True), key=lambda e: (e[0], e[1]))

    node_types = np.array(
        [config.node_type_to_index[d["node_type"]] for _, d in nodes_with_data],
        dtype=np.int64,
    )

    if G.rendering_order_method is not None:
        rendering_orders = np.array(
            [d.get("rendering_order", -1) for _, d in nodes_with_data],
            dtype=np.int64,
        )
    else:
        rendering_orders = None

    if edges_with_data:
        edge_indices = np.array(
            [[s, d] for s, d, _ in edges_with_data], dtype=np.int64
        ).T
    else:
        edge_indices = np.zeros((2, 0), dtype=np.int64)

    if config.siso_only:
        edge_types = None
    else:
        edge_types = []
        for source_id, dest_id, data in edges_with_data:
            source_type = G.nodes[source_id]["node_type"]
            dest_type = G.nodes[dest_id]["node_type"]
            outlet_id = config.outlet_to_index[source_type][data["outlet"]]
            inlet_id = config.inlet_to_index[dest_type][data["inlet"]]
            edge_types.append([outlet_id, inlet_id])
        edge_types = np.array(edge_types, dtype=np.int64).reshape(-1, 2)

    return GRAFXTensor(
        node_types=node_types,
        edge_indices=edge_indices,
        edge_types=edge_types,
        rendering_order_method=G.rendering_order_method,
        rendering_orders=rendering_orders,
        type_sequence=G.type_sequence,
        counter=G.counter,
        batch=G.batch,
        config=G.config,
        config_hash=G.config_hash,
        invalid_op=G.invalid_op,
    )


def _relabel_nodes_to_consecutive_ids(G):
    node_ids = list(G.nodes())
    mapping = {node_ids[i]: i for i in range(len(node_ids))}
    G = relabel_nodes(G, mapping)
    G.graph["consecutive_ids"] = True
    return G
