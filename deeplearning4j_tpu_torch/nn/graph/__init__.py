from .computation_graph import ComputationGraph

__all__ = ["ComputationGraph"]
