"""Text: port of deeplearning4j_tpu/text/ (tokenizers and sentence and
document iterators, the annotation pipeline, the trained POS tagger and
chunker, the tree parser, Porter stemming, the inverted index, the
bag-of-words and TF-IDF vectorizers, and the CJK tokenizers with the
Japanese lattice and dictionaries and the Korean morphology). All of it
is stdlib and numpy, on the host."""
from .annotation import (AnnotatedDocument, Annotation,
                         AnnotationPipeline, Annotator,
                         PosAnnotator, SentenceAnnotator,
                         StemAnnotator, TokenAnnotator,
                         standard_pipeline)
from .pos_model import (PerceptronChunker, PerceptronPosTagger,
                        TrainedPosAnnotator)
from .cjk_tokenization import (ChineseTokenizerFactory,
                               JapaneseTokenizerFactory,
                               KoreanTokenizerFactory)
from .document_iterator import (AsyncLabelAwareIterator,
                                BasicLabelAwareIterator, DocumentIterator,
                                FileDocumentIterator, FileLabelAwareIterator,
                                FilenamesLabelAwareIterator,
                                LabelAwareDocumentIterator, LabelledDocument,
                                SimpleLabelAwareIterator)
from .inverted_index import InMemoryInvertedIndex
from .ja_dictionary import (MecabDictionary, compile_dictionary,
                            parse_user_dictionary)
from .ja_lattice import (JapaneseLatticeTokenizer,
                         JapaneseLatticeTokenizerFactory)
from .ko_dictionary import KoreanDictionary, load_dictionary
from .ko_morph import KoreanMorphTokenizer, KoreanMorphTokenizerFactory
from .sentence_iterator import (BasicLineIterator, CollectionSentenceIterator,
                                FileSentenceIterator, LabelAwareIterator,
                                LabelAwareListSentenceIterator, LabelsSource,
                                SentenceIterator)
from .stemming import StemmingPreprocessor, porter_stem
from .tokenization import (CommonPreprocessor, DefaultTokenizerFactory,
                           EndingPreProcessor, LowCasePreProcessor,
                           NGramTokenizerFactory, TokenPreProcess, Tokenizer,
                           TokenizerFactory)
from .vectorizers import BagOfWordsVectorizer, TfidfVectorizer

__all__ = [
    "AnnotatedDocument", "Annotation", "AnnotationPipeline", "Annotator",
    "AsyncLabelAwareIterator", "BagOfWordsVectorizer",
    "BasicLabelAwareIterator", "BasicLineIterator", "ChineseTokenizerFactory",
    "CollectionSentenceIterator", "CommonPreprocessor",
    "DefaultTokenizerFactory", "DocumentIterator", "EndingPreProcessor",
    "FileDocumentIterator", "FileLabelAwareIterator",
    "FileSentenceIterator", "FilenamesLabelAwareIterator",
    "InMemoryInvertedIndex", "JapaneseLatticeTokenizer",
    "JapaneseLatticeTokenizerFactory", "JapaneseTokenizerFactory",
    "KoreanDictionary", "KoreanMorphTokenizer", "KoreanMorphTokenizerFactory",
    "MecabDictionary", "compile_dictionary", "load_dictionary",
    "parse_user_dictionary",
    "KoreanTokenizerFactory", "LabelAwareDocumentIterator",
    "LabelAwareIterator", "LabelAwareListSentenceIterator",
    "LabelledDocument", "LabelsSource", "LowCasePreProcessor",
    "NGramTokenizerFactory", "SentenceIterator", "SimpleLabelAwareIterator",
    "StemmingPreprocessor", "TfidfVectorizer", "TokenPreProcess",
    "PerceptronChunker", "PerceptronPosTagger", "PosAnnotator",
    "SentenceAnnotator",
    "StemAnnotator", "TrainedPosAnnotator",
    "TokenAnnotator", "Tokenizer", "TokenizerFactory", "porter_stem",
    "standard_pipeline",
]
