from .vocab import VocabCache, VocabWord, build_huffman

__all__ = ["StaticWord2Vec", "VocabCache", "VocabWord", "Word2Vec",
           "build_huffman", "write_static_model"]


def __getattr__(name):
    # lazy: word2vec.py imports SequenceVectors, which imports .vocab from
    # this package — a direct import here would be circular
    if name == "Word2Vec":
        from .word2vec import Word2Vec
        return Word2Vec
    if name in ("StaticWord2Vec", "write_static_model"):
        from . import static_word2vec as _s
        return getattr(_s, name)
    raise AttributeError(name)
