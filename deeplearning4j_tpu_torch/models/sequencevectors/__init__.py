from .sequence_vectors import SequenceVectors

__all__ = ["SequenceVectors"]
