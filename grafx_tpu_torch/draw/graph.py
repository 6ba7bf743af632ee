"""Top-level graph drawing (reference: src/grafx/draw/graph.py:9-119)."""

from grafx_tpu_torch.draw.edge import draw_edge
from grafx_tpu_torch.draw.node import draw_node
from grafx_tpu_torch.draw.position import compute_node_position
from grafx_tpu_torch.draw.style import NodeColorHandler


def draw_grafx(
    G,
    vertical=False,
    compute_node_position_fn=compute_node_position,
    draw_node_fn=draw_node,
    draw_edge_fn=draw_edge,
    colors=None,
    **kwargs,
):
    """Draw a :class:`GRAFX` graph with matplotlib.

    Keyword arguments prefixed ``node_`` / ``edge_`` / ``position_`` are
    routed to the node / edge / position functions respectively.

    Returns:
        ``(fig, ax)``.
    """
    node_kwargs, edge_kwargs, position_kwargs = {}, {}, {}
    for k, v in kwargs.items():
        prefix, _, rest = k.partition("_")
        if not rest:
            raise ValueError(f"Wrong argument: {k}")
        match prefix:
            case "node":
                node_kwargs[rest] = v
            case "edge":
                edge_kwargs[rest] = v
            case "position":
                position_kwargs[rest] = v
            case _:
                raise ValueError(f"Wrong prefix: {prefix}")

    if isinstance(colors, dict):
        color_config = NodeColorHandler(facecolor_map=colors)
    else:
        color_config = NodeColorHandler(
            node_types=G.config.node_types, colors=colors
        )

    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    G = G.copy()
    compute_node_position_fn(G, **position_kwargs)
    if vertical:
        for node_id in G.nodes:
            x0, y0 = G.nodes[node_id]["x0"], G.nodes[node_id]["y0"]
            G.nodes[node_id]["x0"], G.nodes[node_id]["y0"] = y0, x0

    fig, ax = plt.subplots()
    for node in G.nodes(data=True):
        draw_node_fn(ax, G, node, color_config, vertical, **node_kwargs)
    for edge in G.edges(data=True):
        draw_edge_fn(ax, G, edge, vertical, **edge_kwargs)

    postprocess_figure(fig, ax)
    return fig, ax


def postprocess_figure(fig, ax, xscale=0.3, yscale=0.3):
    ax.axis("off")
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    fig.set_size_inches((xlim[1] - xlim[0]) * xscale, (ylim[1] - ylim[0]) * yscale)
    ax.invert_yaxis()
