"""Tokenizers and sentence iterators: the two stdlib-only modules of the
reference's `text/` that the embeddings path uses. The rest of the
reference's `text/` (POS, CJK and Korean tokenizers, stemming, vectorizers)
is ROADMAP.md queue 1 item 22."""
from .sentence_iterator import (BasicLineIterator, CollectionSentenceIterator,
                                FileSentenceIterator, LabelAwareIterator,
                                LabelAwareListSentenceIterator, LabelsSource,
                                SentenceIterator)
from .tokenization import (CommonPreprocessor, DefaultTokenizerFactory,
                           EndingPreProcessor, LowCasePreProcessor,
                           NGramTokenizerFactory, TokenPreProcess, Tokenizer,
                           TokenizerFactory)

__all__ = [
    "BasicLineIterator", "CollectionSentenceIterator", "CommonPreprocessor",
    "DefaultTokenizerFactory", "EndingPreProcessor", "FileSentenceIterator",
    "LabelAwareIterator", "LabelAwareListSentenceIterator", "LabelsSource",
    "LowCasePreProcessor", "NGramTokenizerFactory", "SentenceIterator",
    "TokenPreProcess", "Tokenizer", "TokenizerFactory",
]
