from .paragraph_vectors import ParagraphVectors

__all__ = ["ParagraphVectors"]
