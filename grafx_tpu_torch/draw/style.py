"""Node color assignment for graph drawing
(reference: src/grafx/draw/style.py:34-112)."""

import numpy as np

DEFAULT_COLORS = [
    "#E6F9AF", "#F2E3BC", "#FFCC99", "#BAC8D3", "#E1D5E7", "#EAE8FF",
    "#EEEEEE", "#B3BFB8", "#FFE3E0", "#ECE2D0", "#FFCBDD", "#F4F9E9",
    "#FFFF88", "#A1E5B7", "#EEC584", "#FEFEE3", "#D4E09B", "#CCE5FF",
    "#CDEB8B", "#DAFFED", "#9BF3F0", "#EAE1DF", "#FFCCCC", "#D1FFD7",
    "#EFFFFA", "#C3BEF7",
]


class NodeColorHandler:
    """Maps node types to face/edge colors.  Types are assigned a color by
    their initial letter; ``in``/``out`` are white with blue/red borders."""

    def __init__(self, facecolor_map=None, node_types=None, colors=None):
        if facecolor_map is not None:
            self.facecolor_map = facecolor_map
            return
        colors = DEFAULT_COLORS if colors is None else colors
        rng = np.random.RandomState(0)
        self.facecolor_map = {}
        idxs = list(range(len(colors)))
        for node_type in node_types:
            if node_type in ("in", "out"):
                continue
            idx = ord(node_type[0].lower()) - 97
            idx %= len(colors)
            if idxs:
                while idx not in idxs:
                    idx = (idx + 1) % len(colors)
                idxs.remove(idx)
                self.facecolor_map[node_type] = colors[idx]
            else:
                import matplotlib.pyplot as plt

                cmap = plt.get_cmap("jet")
                self.facecolor_map[node_type] = cmap(rng.uniform())

    def get_facecolor(self, node_type):
        if node_type in ("in", "out"):
            return "w"
        return self.facecolor_map[node_type]

    def get_edgecolor(self, node_type):
        match node_type:
            case "in":
                return "b"
            case "out":
                return "r"
            case _:
                return "k"

    def get_colors(self, node_type):
        return {
            "facecolor": self.get_facecolor(node_type),
            "edgecolor": self.get_edgecolor(node_type),
        }
