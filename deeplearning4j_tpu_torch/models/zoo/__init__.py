from .char_rnn import char_rnn, char_rnn_conf
from .classic_cnns import (alexnet, alexnet_conf, googlenet,
                           googlenet_conf, vgg16, vgg16_conf)
from .lenet import lenet, lenet_conf
from .resnet import resnet50, resnet50_conf
from .transformer import TransformerLM, init_lm

__all__ = ["TransformerLM", "alexnet", "alexnet_conf", "char_rnn",
           "char_rnn_conf", "googlenet", "googlenet_conf", "init_lm", "lenet",
           "lenet_conf", "resnet50", "resnet50_conf", "vgg16", "vgg16_conf"]
