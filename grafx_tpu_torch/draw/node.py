"""Node rendering: rectangle, labels, and inlet/outlet anchor points
(reference: src/grafx/draw/node.py:12-156)."""


def _plot_extent_points(ax, p0, off_x, off_y):
    # invisible points so matplotlib autoscales the axes correctly
    ax.plot(p0[0], p0[1], alpha=0)
    ax.plot(p0[0] + off_x, p0[1] + off_y, alpha=0)


def draw_node(
    ax,
    G,
    node,
    color_config,
    vertical=False,
    inside="node_type",
    above=None,
    size=(0.5, 0.5),
    linewidth=0.6,
    inside_fontsize=5.6,
    above_fontsize=3.0,
):
    """Draw one node as a rectangle with optional inside/above labels;
    stores inlet/outlet anchor points in ``node["meta"]``."""
    from matplotlib.patches import Rectangle

    node_id, node = node
    p0 = (node["x0"], node["y0"])
    node_type = node["node_type"]
    config = G.config[node_type]

    _plot_extent_points(ax, p0, size[0], size[1])
    colors = color_config.get_colors(node_type)
    ax.add_patch(Rectangle(p0, size[0], size[1], linewidth=linewidth, **colors))

    def label_text(key):
        allowed = ["node_id"] + list(node.keys())
        if key not in allowed:
            raise ValueError(f"Provided label '{key}'; allowed: {allowed}")
        if key == "node_id":
            return node_id
        if key == "node_type":
            return node_type[0] if key == inside else node_type[:4]
        return node[key]

    header_y = p0[1] + size[1] / 2
    if inside != "node_type":
        header_y += 0.025
    ax.text(
        p0[0] + size[0] / 2,
        header_y,
        label_text(inside),
        fontsize=inside_fontsize,
        ha="center",
        va="center",
    )
    if above is not None:
        ax.text(
            p0[0],
            p0[1] - 0.13,
            label_text(above),
            color="g",
            zorder=5,
            fontsize=above_fontsize,
            ha="left",
            va="center",
        )

    def anchor_points(names, at_start):
        points = {}
        n = len(names)
        if vertical:
            dx = size[0] / (n + 1)
            y = p0[1] if at_start else p0[1] + size[1]
            for i, name in enumerate(names):
                points[name] = (p0[0] + dx * (i + 1), y)
        else:
            dy = size[1] / (n + 1)
            x = p0[0] if at_start else p0[0] + size[0]
            for i, name in enumerate(names):
                points[name] = (x, p0[1] + dy * (i + 1))
        return points

    node["meta"] = {
        "y": size[1],
        "in_points": anchor_points(config["inlets"], at_start=True),
        "out_points": anchor_points(config["outlets"], at_start=False),
    }
