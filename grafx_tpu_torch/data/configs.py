"""Node-type configuration registry.

Behavioral parity with the reference ``NodeConfigs``
(reference: src/grafx/data/configs.py:10-126): utility types ``"in"``,
``"out"``, and ``"mix"`` are auto-injected, a list config means all-SISO
defaults, and a dict config supplies explicit inlet/outlet names (MIMO).
"""

IN = {"inlets": [], "outlets": ["main"]}
OUT = {"inlets": ["main"], "outlets": []}
DEFAULT = {"inlets": ["main"], "outlets": ["main"]}
UTILITY_TYPES = ["in", "out", "mix"]
UTILITY_DICT = {"in": IN, "out": OUT, "mix": DEFAULT}


class NodeConfigs:
    """Registry of node types and their inlets/outlets.

    Args:
        config: a ``list`` of node-type names (all SISO) or a ``dict``
            mapping type names to ``{"inlets": [...], "outlets": [...]}``.

    Attributes mirror the reference: ``node_type_dict``, ``node_types``,
    ``node_type_to_index``, ``num_node_types``, ``num_inlets``,
    ``num_outlets``, ``siso_only``, and (MIMO only) ``max_num_inlets``,
    ``max_num_outlets``, ``inlet_to_index``, ``outlet_to_index``.
    """

    def __init__(self, config):
        if isinstance(config, list):
            node_type_dict = {
                k: self._default_config(k) for k in UTILITY_TYPES + config
            }
        elif isinstance(config, dict):
            node_type_dict = {**UTILITY_DICT, **config}
        else:
            raise ValueError(f"Invalid config type: {type(config)}")
        self._unpack(node_type_dict)

    @staticmethod
    def _default_config(node_type):
        if node_type == "in":
            return IN
        if node_type == "out":
            return OUT
        return DEFAULT

    def _unpack(self, node_type_dict):
        self.node_type_dict = node_type_dict
        self.node_types = list(node_type_dict)
        self.num_node_types = len(self.node_types)
        self.node_type_to_index = {t: i for i, t in enumerate(self.node_types)}

        self.num_inlets = {}
        self.num_outlets = {}
        inlet_to_index, outlet_to_index = {}, {}
        max_in, max_out = 1, 1
        for node_type, cfg in node_type_dict.items():
            inlets, outlets = cfg["inlets"], cfg["outlets"]
            self.num_inlets[node_type] = len(inlets)
            self.num_outlets[node_type] = len(outlets)
            inlet_to_index[node_type] = {n: i for i, n in enumerate(inlets)}
            outlet_to_index[node_type] = {n: i for i, n in enumerate(outlets)}
            max_in = max(max_in, len(inlets))
            max_out = max(max_out, len(outlets))

        self.siso_only = (max_in == 1) and (max_out == 1)
        if not self.siso_only:
            self.max_num_inlets = max_in
            self.max_num_outlets = max_out
            self.inlet_to_index = inlet_to_index
            self.outlet_to_index = outlet_to_index

    def __getitem__(self, node_type):
        return self.node_type_dict[node_type]

    def __str__(self):
        lines = [
            f"NodeConfigs with {self.num_node_types} node types"
            f" (siso_only={self.siso_only})"
        ]
        for node_type, cfg in self.node_type_dict.items():
            idx = self.node_type_to_index[node_type]

            def fmt(names):
                return f"<{', '.join(names)}>" if names else "None"

            lines.append(
                f"  ({idx}) {node_type}: {fmt(cfg['inlets'])} ->"
                f" {fmt(cfg['outlets'])}"
            )
        return "\n".join(lines)
