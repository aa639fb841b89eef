from .lenet import lenet, lenet_conf
from .resnet import resnet50, resnet50_conf
from .transformer import TransformerLM, init_lm

__all__ = ["TransformerLM", "init_lm", "lenet", "lenet_conf", "resnet50",
           "resnet50_conf"]
