from .zoo import TransformerLM, lenet, resnet50

__all__ = ["TransformerLM", "lenet", "resnet50"]
