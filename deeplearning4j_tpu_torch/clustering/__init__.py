"""Clustering: port of deeplearning4j_tpu/clustering/ (k-means, whose Lloyd
step runs on the device, and the VP and KD trees, numpy)."""
from .kmeans import KMeansClustering
from .trees import KDTree, VPTree

__all__ = ["KDTree", "KMeansClustering", "VPTree"]
