"""Visualisation: port of deeplearning4j_tpu/plot/ (t-SNE)."""
from .tsne import BarnesHutTsne, Tsne

__all__ = ["BarnesHutTsne", "Tsne"]
