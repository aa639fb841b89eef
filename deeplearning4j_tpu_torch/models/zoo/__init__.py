from .transformer import TransformerLM, init_lm

__all__ = ["TransformerLM", "init_lm"]
