"""A small directed multigraph with the networkx calls the graph layer uses.

``grafx_tpu``'s ``GRAFX`` subclasses ``networkx.MultiDiGraph``; the port
keeps the same host-side API without that dependency.  Node and edge
iteration follow insertion order, as in networkx, so schedules and
fusion passes that walk ``edges(data=True)`` visit edges in the same
order on both packages.
"""


class _NodeView:
    """``G.nodes``: callable (``G.nodes()``, ``G.nodes(data=True)``),
    iterable over node ids, and indexable to the node's attribute dict."""

    def __init__(self, nodes):
        self._nodes = nodes

    def __call__(self, data=False):
        return list(self._nodes.items()) if data else list(self._nodes)

    def __iter__(self):
        return iter(self._nodes)

    def __len__(self):
        return len(self._nodes)

    def __contains__(self, n):
        return n in self._nodes

    def __getitem__(self, n):
        return self._nodes[n]


class MultiDiGraph:
    """Directed multigraph: ``_succ[u][v][key]`` and ``_pred[v][u][key]``
    share one attribute dict per edge."""

    def __init__(self):
        self.graph = {}
        self._node = {}
        self._succ = {}
        self._pred = {}

    # -- nodes ---------------------------------------------------------

    @property
    def nodes(self):
        return _NodeView(self._node)

    def add_node(self, n, **attr):
        if n not in self._node:
            self._node[n] = {}
            self._succ[n] = {}
            self._pred[n] = {}
        self._node[n].update(attr)

    def add_nodes_from(self, nodes):
        for item in nodes:
            if isinstance(item, tuple):
                n, attr = item
                self.add_node(n, **attr)
            else:
                self.add_node(item)

    def remove_node(self, n):
        for v in self._succ[n]:
            del self._pred[v][n]
        for u in self._pred[n]:
            del self._succ[u][n]
        del self._succ[n], self._pred[n], self._node[n]

    def number_of_nodes(self):
        return len(self._node)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)

    def __contains__(self, n):
        return n in self._node

    def copy(self):
        """A copy with its own graph, node and edge attribute dicts (their
        values shared), as ``networkx``'s ``G.copy()``."""
        H = self.__class__()
        H.graph.update(self.graph)
        for n, d in self._node.items():
            H.add_node(n, **d)
        for u, v, k, d in self.edges(data=True, keys=True):
            H.add_edge(u, v, key=k, **d)
        return H

    # -- edges ---------------------------------------------------------

    def add_edge(self, u, v, key=None, **attr):
        for n in (u, v):
            if n not in self._node:
                self.add_node(n)
        keydict = self._succ[u].setdefault(v, {})
        self._pred[v].setdefault(u, keydict)
        if key is None:
            key = len(keydict)
            while key in keydict:
                key += 1
        keydict.setdefault(key, {}).update(attr)
        return key

    def add_edges_from(self, edges):
        for u, v, *rest in edges:
            self.add_edge(u, v, **(rest[0] if rest else {}))

    def has_edge(self, u, v):
        return u in self._succ and v in self._succ[u]

    def get_edge_data(self, u, v):
        """``{key: attr}`` of the ``u -> v`` edges, or ``None``."""
        if not self.has_edge(u, v):
            return None
        return self._succ[u][v]

    def edges(self, data=False, keys=False):
        return self._edges(self._node, self._succ, data, keys, forward=True)

    def out_edges(self, nbunch=None, data=False):
        nodes = self._node if nbunch is None else self._bunch(nbunch)
        return self._edges(nodes, self._succ, data, False, forward=True)

    def in_edges(self, nbunch=None, data=False):
        nodes = self._node if nbunch is None else self._bunch(nbunch)
        return self._edges(nodes, self._pred, data, False, forward=False)

    @staticmethod
    def _bunch(nbunch):
        return list(nbunch) if isinstance(nbunch, (list, tuple, set)) else [nbunch]

    @staticmethod
    def _edges(nodes, adj, data, keys, forward):
        out = []
        for n in nodes:
            for nbr, keydict in adj[n].items():
                u, v = (n, nbr) if forward else (nbr, n)
                for k, d in keydict.items():
                    e = (u, v, k) if keys else (u, v)
                    out.append(e + (d,) if data else e)
        return out

    def number_of_edges(self):
        return sum(len(kd) for nbrs in self._succ.values() for kd in nbrs.values())

    def successors(self, n):
        return iter(self._succ[n])

    def predecessors(self, n):
        return iter(self._pred[n])

    def out_degree(self, n):
        return sum(len(kd) for kd in self._succ[n].values())

    def in_degree(self, n):
        return sum(len(kd) for kd in self._pred[n].values())


def union_all(graphs):
    """The union of graphs whose node sets are disjoint, as
    ``networkx.union_all``: a graph of the first one's class, holding
    every node and edge (keys kept) with its attributes, and the graph
    attributes of each in turn (a later graph's value wins)."""
    R, seen = None, set()
    for i, G in enumerate(graphs):
        nodes = set(G.nodes)
        if i == 0:
            R = G.__class__()
        elif not seen.isdisjoint(nodes):
            raise ValueError("The node sets of the graphs are not disjoint.")
        seen |= nodes
        R.graph.update(G.graph)
        for n, d in G.nodes(data=True):
            R.add_node(n, **d)
        for u, v, k, d in G.edges(data=True, keys=True):
            R.add_edge(u, v, key=k, **d)
    if R is None:
        raise ValueError("cannot apply union_all to an empty list")
    return R


def topological_sort(G):
    """The nodes of a DAG in ``networkx.topological_sort``'s order:
    generation by generation (Kahn's algorithm), each generation in the
    order its nodes became ready, successors visited in insertion order.
    Raises ``ValueError`` on a cycle."""
    indegree = {v: G.in_degree(v) for v in G.nodes if G.in_degree(v) > 0}
    generation = [v for v in G.nodes if G.in_degree(v) == 0]
    order = []
    while generation:
        order += generation
        ready = []
        for node in generation:
            for child, keydict in G._succ[node].items():
                indegree[child] -= len(keydict)
                if indegree[child] == 0:
                    ready.append(child)
                    del indegree[child]
        generation = ready
    if indegree:
        raise ValueError("Graph contains a cycle")
    return order


def relabel_nodes(G, mapping):
    """Copy of ``G`` with node ids mapped through ``mapping`` (ids missing
    from it are kept), as ``networkx.relabel_nodes(G, mapping, copy=True)``."""
    H = G.__class__()
    for n, d in G.nodes(data=True):
        H.add_node(mapping.get(n, n), **dict(d))
    for u, v, k, d in G.edges(data=True, keys=True):
        H.add_edge(mapping.get(u, u), mapping.get(v, v), key=k, **dict(d))
    H.graph.update(G.graph)
    return H
