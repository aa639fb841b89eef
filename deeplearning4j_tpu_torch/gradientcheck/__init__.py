from .gradient_check_util import check_gradients

__all__ = ["check_gradients"]
