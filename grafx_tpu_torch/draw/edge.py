"""Edge rendering with cubic Bezier curves
(reference: src/grafx/draw/edge.py:6-54; the vendored recursive Bezier of
draw/bezier.py is replaced by the closed-form cubic polynomial)."""

import numpy as np


def cubic_bezier(t, P):
    """Closed-form cubic Bezier curve: ``P`` is ``(4, 2)`` control points,
    ``t`` is ``(T,)``; returns ``(T, 2)``."""
    t = t[:, None]
    u = 1.0 - t
    return (
        u**3 * P[0]
        + 3 * u**2 * t * P[1]
        + 3 * u * t**2 * P[2]
        + t**3 * P[3]
    )


def add_edge_curve(ax, p_from, p_to, vertical=False, linewidth=0.6, eps=0.02):
    if p_from[1] == p_to[1] and not vertical:
        ax.plot(
            [p_from[0], p_to[0]],
            [p_from[1], p_to[1]],
            c="k",
            zorder=-1,
            linewidth=0.7,
        )
        return
    if vertical:
        mid_y = (p_to[1] + p_from[1]) / 2
        P = np.array(
            [
                [p_from[0], p_from[1] - eps],
                [p_from[0], mid_y],
                [p_to[0], mid_y],
                [p_to[0], p_to[1] + eps],
            ]
        )
    else:
        mid_x = (p_to[0] + p_from[0]) / 2
        P = np.array(
            [
                [p_from[0] + eps, p_from[1]],
                [mid_x, p_from[1]],
                [mid_x, p_to[1]],
                [p_to[0] - eps, p_to[1]],
            ]
        )
    curve = cubic_bezier(np.linspace(0, 1, 101), P)
    ax.plot(curve[:, 0], curve[:, 1], color="k", zorder=-1, linewidth=0.7)


def draw_edge(ax, G, edge, vertical, linewidth=0.6):
    """Draw one edge from its source outlet anchor to its dest inlet
    anchor."""
    source_id, dest_id, e = edge
    p_from = G.nodes[source_id]["meta"]["out_points"][e["outlet"]]
    p_to = G.nodes[dest_id]["meta"]["in_points"][e["inlet"]]
    add_edge_curve(ax, p_from, p_to, vertical, linewidth=linewidth)
