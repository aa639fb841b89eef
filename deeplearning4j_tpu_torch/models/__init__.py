from .zoo import TransformerLM

__all__ = ["TransformerLM"]
