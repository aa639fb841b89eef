"""Graphs: port of deeplearning4j_tpu/graph/ (the adjacency graph and its
loaders, the random walks, and DeepWalk, whose skip-gram trains on the
device through `SequenceVectors`)."""
from .deepwalk import DeepWalk
from .graph import Edge, Graph, GraphLoader, Vertex
from .walks import RandomWalkIterator, WeightedRandomWalkIterator

__all__ = ["DeepWalk", "Edge", "Graph", "GraphLoader", "RandomWalkIterator",
           "Vertex", "WeightedRandomWalkIterator"]
