"""Tokenizers + token preprocessing.

The port's copy of deeplearning4j_tpu/text/tokenization.py (stdlib only),
held against it by tests/test_torch_embeddings.py; the text below is the
reference's.

TPU-native equivalent of reference text/tokenization/: Tokenizer /
TokenizerFactory SPI (DefaultTokenizer, NGramTokenizer), TokenPreProcess
implementations (CommonPreprocessor, LowCasePreProcessor,
EndingPreProcessor, StemmingPreprocessor-lite).
"""
from __future__ import annotations

import re


class TokenPreProcess:
    def pre_process(self, token):
        raise NotImplementedError

    preProcess = pre_process


class CommonPreprocessor(TokenPreProcess):
    """Strip punctuation + lowercase (reference:
    text/tokenization/tokenizer/preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token):
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token):
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude English suffix stripper (reference:
    text/tokenization/tokenizer/preprocessor/EndingPreProcessor.java)."""

    def pre_process(self, token):
        for suffix in ("sses", "ies", "ed", "ing", "ly", "s"):
            if token.endswith(suffix) and len(token) > len(suffix) + 2:
                if suffix == "sses":
                    return token[:-2]
                if suffix == "ies":
                    return token[:-3] + "y"
                return token[:-len(suffix)]
        return token


class Tokenizer:
    """Iterator-style tokenizer over one string.
    reference: text/tokenization/tokenizer/Tokenizer.java."""

    def __init__(self, tokens, pre_processor=None):
        self._tokens = list(tokens)
        self._pos = 0
        self._pre = pre_processor

    def has_more_tokens(self):
        return self._pos < len(self._tokens)

    hasMoreTokens = has_more_tokens

    def count_tokens(self):
        return len(self._tokens)

    countTokens = count_tokens

    def next_token(self):
        t = self._tokens[self._pos]
        self._pos += 1
        return self._pre.pre_process(t) if self._pre else t

    nextToken = next_token

    def get_tokens(self):
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out

    getTokens = get_tokens


class TokenizerFactory:
    def create(self, text):
        raise NotImplementedError

    def set_token_pre_processor(self, pre):
        self._pre = pre

    setTokenPreProcessor = set_token_pre_processor


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace/word-boundary tokenizer (reference:
    text/tokenization/tokenizerfactory/DefaultTokenizerFactory.java)."""

    _SPLIT = re.compile(r"\s+")

    def __init__(self):
        self._pre = None

    def create(self, text):
        tokens = [t for t in self._SPLIT.split(text.strip()) if t]
        return Tokenizer(tokens, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """n-gram shingles over the base tokens (reference:
    text/tokenization/tokenizerfactory/NGramTokenizerFactory.java)."""

    def __init__(self, base_factory=None, min_n=1, max_n=2):
        self._base = base_factory or DefaultTokenizerFactory()
        self.min_n = int(min_n)
        self.max_n = int(max_n)
        self._pre = None

    def create(self, text):
        base = self._base.create(text).get_tokens()
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base) - n + 1):
                out.append(" ".join(base[i:i + n]))
        return Tokenizer(out, self._pre)
