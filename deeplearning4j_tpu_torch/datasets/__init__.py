"""Datasets: port of deeplearning4j_tpu/datasets/ (so far `DataSet` and
`MultiDataSet`; the iterators are ROADMAP.md queue 1 item 14)."""
from .dataset import DataSet, MultiDataSet

__all__ = ["DataSet", "MultiDataSet"]
