from .glove import Glove
from .paragraphvectors import ParagraphVectors
from .sequencevectors import SequenceVectors
from .word2vec import Word2Vec
from .zoo import TransformerLM, lenet, resnet50

__all__ = ["Glove", "ParagraphVectors", "SequenceVectors", "TransformerLM",
           "Word2Vec", "lenet", "resnet50"]
