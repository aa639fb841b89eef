"""Graph API + storage + loaders.

The port's copy of deeplearning4j_tpu/graph/graph.py, held against it by
tests/test_torch_graph.py; the text below is the reference's.

TPU-native equivalent of reference deeplearning4j-graph:
api/IGraph.java, graph/Graph.java (adjacency-list), data/GraphLoader.java
(delimited edge-list files).
"""
from __future__ import annotations


class Vertex:
    """reference: api/Vertex.java"""

    __slots__ = ("idx", "value")

    def __init__(self, idx, value=None):
        self.idx = int(idx)
        self.value = value

    def __repr__(self):
        return f"Vertex({self.idx}, {self.value!r})"


class Edge:
    """reference: api/Edge.java"""

    __slots__ = ("from_idx", "to_idx", "weight", "directed")

    def __init__(self, from_idx, to_idx, weight=1.0, directed=False):
        self.from_idx = int(from_idx)
        self.to_idx = int(to_idx)
        self.weight = float(weight)
        self.directed = bool(directed)


class Graph:
    """Adjacency-list graph. reference: graph/Graph.java (implements IGraph)."""

    def __init__(self, num_vertices, allow_multiple_edges=True):
        self._vertices = [Vertex(i) for i in range(int(num_vertices))]
        self._adj = [[] for _ in range(int(num_vertices))]   # list[list[Edge]]
        self.allow_multiple_edges = allow_multiple_edges

    def num_vertices(self):
        return len(self._vertices)

    numVertices = num_vertices

    def get_vertex(self, idx):
        return self._vertices[idx]

    getVertex = get_vertex

    def set_vertex_value(self, idx, value):
        self._vertices[idx].value = value

    def add_edge(self, from_idx, to_idx, weight=1.0, directed=False):
        """reference: Graph.addEdge — undirected edges are stored on both
        endpoints."""
        e = Edge(from_idx, to_idx, weight, directed)
        if not self.allow_multiple_edges and any(
                x.to_idx == e.to_idx for x in self._adj[e.from_idx]):
            return
        self._adj[e.from_idx].append(e)
        if not directed and from_idx != to_idx:
            self._adj[e.to_idx].append(Edge(to_idx, from_idx, weight, directed))

    addEdge = add_edge

    def get_edges_out(self, idx):
        return list(self._adj[idx])

    getEdgesOut = get_edges_out

    def get_connected_vertex_indices(self, idx):
        return [e.to_idx for e in self._adj[idx]]

    getConnectedVertexIndices = get_connected_vertex_indices

    def degree(self, idx):
        return len(self._adj[idx])


class GraphLoader:
    """Delimited file loaders. reference: data/GraphLoader.java."""

    @staticmethod
    def load_undirected_graph_edge_list_file(path, num_vertices, delim=","):
        """Each line: `from<delim>to[<delim>weight]`.
        reference: GraphLoader.loadUndirectedGraphEdgeListFile."""
        g = Graph(num_vertices)
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delim)
                w = float(parts[2]) if len(parts) > 2 else 1.0
                g.add_edge(int(parts[0]), int(parts[1]), w, directed=False)
        return g

    loadUndirectedGraphEdgeListFile = load_undirected_graph_edge_list_file

    @staticmethod
    def load_adjacency_list_file(path, delim=","):
        """Each line: `vertex<delim>n1<delim>n2...` (directed edges).
        reference: GraphLoader.loadAdjacencyListFile."""
        rows = []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([int(x) for x in line.split(delim)])
        n = max(max(r) for r in rows) + 1
        g = Graph(n)
        for r in rows:
            for to in r[1:]:
                g.add_edge(r[0], to, directed=True)
        return g
