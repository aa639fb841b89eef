from . import model_utils, serializer
from .learning import CBOW, SkipGram
from .lookup_table import InMemoryLookupTable

WordVectorSerializer = serializer

__all__ = ["CBOW", "InMemoryLookupTable", "SkipGram", "WordVectorSerializer",
           "model_utils", "serializer"]
