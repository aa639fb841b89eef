from .glove import Glove

__all__ = ["Glove"]
