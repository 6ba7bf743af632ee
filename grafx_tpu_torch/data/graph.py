"""Mutable audio-processing graph.

The port of :mod:`grafx_tpu.data.graph`: a typed multigraph DAG with
sequential integer node ids, config-validated mutation ops, an
``invalid_op`` policy, and pretty-printing.  Host-side only; it builds on
the in-package :class:`~grafx_tpu_torch.data._multigraph.MultiDiGraph`
in place of networkx.
"""

import warnings

from grafx_tpu_torch.data._multigraph import MultiDiGraph


class GRAFX(MultiDiGraph):
    """A mutable audio processing graph (typed multigraph DAG).

    Args:
        config: optional :class:`~grafx_tpu_torch.data.configs.NodeConfigs`.
        invalid_op: ``"error"`` / ``"warn"`` / ``"mute"`` behavior when an
            invalid mutation is attempted.
    """

    def __init__(self, config=None, invalid_op="error"):
        if invalid_op not in ("error", "warn", "mute"):
            raise ValueError(f"Incorrect invalid_op is given: {invalid_op}.")
        super().__init__()
        self.graph = dict(
            counter=0,
            consecutive_ids=True,
            batch=False,
            config=config,
            config_hash=hash(config),
            invalid_op=invalid_op,
            rendering_order_method=None,
            type_sequence=None,
        )

    # -- mutation ops -------------------------------------------------------

    def add(self, node_type, parameters=None, name=None):
        """Add a node; returns its sequential integer id."""
        config = self.graph["config"]
        if config is not None and node_type not in config.node_types:
            self.raise_warning(
                f"Invalid node_type: {node_type}, this graph only allows"
                f" {config.node_types}."
            )
            return None
        node_id = self.graph["counter"]
        assert node_id not in self.nodes()
        self.add_node(node_id, node_type=node_type, parameters=parameters, name=name)
        self.graph["counter"] += 1
        return node_id

    def remove(self, node_id):
        """Remove a node; returns its (incoming, outgoing) edges."""
        incoming = list(self.in_edges(node_id, data=True))
        outgoing = list(self.out_edges(node_id, data=True))
        self.remove_node(node_id)
        self.graph["consecutive_ids"] = False
        return incoming, outgoing

    def connect(self, source_id, dest_id, outlet="main", inlet="main"):
        """Connect two nodes, validating outlet/inlet names against the
        config and rejecting duplicate edges and self-loops."""
        if self.has_edge(source_id, dest_id):
            for cand in self.get_edge_data(source_id, dest_id).values():
                if cand["outlet"] == outlet and cand["inlet"] == inlet:
                    self.raise_warning(
                        f"{source_id} <{outlet}> -> {dest_id} <{inlet}>:"
                        " this edge already exists in the graph."
                    )
        if source_id == dest_id:
            self.raise_warning("self-loops are not supported.")

        config = self.graph["config"]
        source_type = self.nodes[source_id]["node_type"]
        dest_type = self.nodes[dest_id]["node_type"]
        if config is not None:
            outlets = config.node_type_dict[source_type]["outlets"]
            if outlet not in outlets:
                self.raise_warning(
                    f"Provided outlet: '{outlet}', while {source_type} only"
                    f" accepts {outlets}."
                )
                return
            inlets = config.node_type_dict[dest_type]["inlets"]
            if inlet not in inlets:
                self.raise_warning(
                    f"Provided inlet: '{inlet}', while {dest_type} only"
                    f" accepts {inlets}."
                )
                return
        self.add_edge(source_id, dest_id, outlet=outlet, inlet=inlet)

    def add_serial_chain(self, node_list):
        """Add a chain of nodes connected in series; returns the first and
        last node ids."""
        first_id = last_id = None
        prev_id = None
        for i, node_data in enumerate(node_list):
            if isinstance(node_data, str):
                node_id = self.add(node_data)
            else:
                node_id = self.add(**node_data)
            if i == 0:
                first_id = node_id
            else:
                self.connect(prev_id, node_id)
            prev_id = node_id
        last_id = prev_id
        return first_id, last_id

    def raise_warning(self, message):
        match self.graph["invalid_op"]:
            case "error":
                raise RuntimeError(message)
            case "warn":
                warnings.warn("Following operation is invalid: " + message)
            case "mute":
                return
            case _:
                raise AssertionError

    # -- pretty-print -------------------------------------------------------

    def __str__(self):
        lines = [
            f"GRAFX with {self.number_of_nodes()} nodes &"
            f" {self.number_of_edges()} edges"
        ]
        for i, data in self.nodes(data=True):
            line = f"  [{i}] {data['node_type']}"
            out_edges = list(self.out_edges([i], data=True))

            def edge_str(e):
                _, to, cfg = e
                outlet, inlet = cfg["outlet"], cfg["inlet"]
                s = f"<{outlet}>" if outlet != "main" else ""
                s += " -> "
                if inlet != "main":
                    s += f"<{inlet}> "
                return s + f"[{to}] {self.nodes[to]['node_type']}"

            if len(out_edges) == 1:
                line += " " + edge_str(out_edges[0]).lstrip()
            elif len(out_edges) > 1:
                line += "\n" + "\n".join("    " + edge_str(e) for e in out_edges)
            lines.append(line)
        return "\n".join(lines)

    # -- property accessors (reference: data/graph.py:234-302) --------------

    @property
    def counter(self):
        return self.graph["counter"]

    @counter.setter
    def counter(self, val):
        self.graph["counter"] = val

    @property
    def consecutive_ids(self):
        return self.graph["consecutive_ids"]

    @consecutive_ids.setter
    def consecutive_ids(self, val):
        assert isinstance(val, bool)
        self.graph["consecutive_ids"] = val

    @property
    def batch(self):
        return self.graph["batch"]

    @batch.setter
    def batch(self, val):
        assert isinstance(val, bool)
        self.graph["batch"] = val

    @property
    def config(self):
        return self.graph["config"]

    @config.setter
    def config(self, val):
        raise AttributeError("config cannot be set after initialization.")

    @property
    def config_hash(self):
        return self.graph["config_hash"]

    @config_hash.setter
    def config_hash(self, val):
        raise AttributeError("config_hash cannot be set directly.")

    @property
    def invalid_op(self):
        return self.graph["invalid_op"]

    @invalid_op.setter
    def invalid_op(self, val):
        assert isinstance(val, str)
        self.graph["invalid_op"] = val

    @property
    def rendering_order_method(self):
        return self.graph["rendering_order_method"]

    @rendering_order_method.setter
    def rendering_order_method(self, val):
        assert isinstance(val, str)
        self.graph["rendering_order_method"] = val

    @property
    def type_sequence(self):
        return self.graph["type_sequence"]

    @type_sequence.setter
    def type_sequence(self, val):
        self.graph["type_sequence"] = val
