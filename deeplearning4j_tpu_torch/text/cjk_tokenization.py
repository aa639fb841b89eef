"""Japanese / Korean / Chinese tokenizers — script-aware segmentation.

The port's copy of deeplearning4j_tpu/text/cjk_tokenization.py, held against
it by tests/test_torch_cjk.py; the text below is the reference's.

TPU-native equivalents of the reference's language modules
(deeplearning4j-nlp-japanese: vendored Kuromoji morphological analyzer;
deeplearning4j-nlp-korean: vendored KoreanText analyzer; ~9k LoC of
dictionaries and Viterbi lattices). Those are third-party analyzers the
reference vendors wholesale; re-vendoring them is neither possible here
(no dictionaries available offline) nor the point of a TPU rebuild. These
tokenizers provide the same TokenizerFactory SPI with honest, rule-based
segmentation:

- JapaneseTokenizer: splits on script-class transitions (kanji / hiragana /
  katakana / latin / digits), the standard dictionary-free baseline for
  Japanese, plus attaches trailing hiragana okurigana to a kanji stem when
  `attach_okurigana` is set.
- KoreanTokenizer: whitespace + punctuation segmentation (Korean spaces
  words), with optional particle stripping for the most common postpositions.
- ChineseTokenizer: per-character segmentation of han runs (the standard
  dictionary-free baseline), other scripts by runs.

For dictionary-exact parity a user can plug any external analyzer through
the TokenizerFactory SPI — the seam is identical to the reference's.
"""
from __future__ import annotations

import re

from .tokenization import Tokenizer, TokenizerFactory


def _script(ch):
    cp = ord(ch)
    if 0x3040 <= cp <= 0x309F:
        return "hiragana"
    if 0x30A0 <= cp <= 0x30FF or cp == 0x30FC:
        return "katakana"
    if (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF):
        return "han"
    if 0xAC00 <= cp <= 0xD7AF or 0x1100 <= cp <= 0x11FF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


def _script_runs(text):
    runs = []
    cur, cur_script = [], None
    for ch in text:
        s = _script(ch)
        if s in ("space", "other"):
            if cur:
                runs.append(("".join(cur), cur_script))
                cur, cur_script = [], None
            continue
        if s != cur_script and cur:
            runs.append(("".join(cur), cur_script))
            cur = []
        cur.append(ch)
        cur_script = s
    if cur:
        runs.append(("".join(cur), cur_script))
    return runs


class JapaneseTokenizer(Tokenizer):
    """reference: deeplearning4j-nlp-japanese JapaneseTokenizer.java
    (Kuromoji-backed there; script-transition segmentation here)."""

    def __init__(self, text, attach_okurigana=True):
        tokens = []
        runs = _script_runs(text)
        i = 0
        while i < len(runs):
            tok, script = runs[i]
            # kanji stem + following hiragana tail = one word (okurigana)
            if attach_okurigana and script == "han" and i + 1 < len(runs) \
                    and runs[i + 1][1] == "hiragana" \
                    and len(runs[i + 1][0]) <= 2:
                tokens.append(tok + runs[i + 1][0])
                i += 2
                continue
            tokens.append(tok)
            i += 1
        super().__init__(tokens)


class KoreanTokenizer(Tokenizer):
    """reference: deeplearning4j-nlp-korean KoreanTokenizer.java.
    Whitespace/punctuation segmentation + optional common-particle
    stripping (은/는/이/가/을/를/의/에/로/와/과/도/만)."""

    _PARTICLES = ("은", "는", "이", "가", "을", "를", "의", "에", "로",
                  "와", "과", "도", "만", "에서", "부터", "까지")

    def __init__(self, text, strip_particles=True):
        raw = re.split(r"[\s\W]+", text, flags=re.UNICODE)
        tokens = []
        for t in raw:
            if not t:
                continue
            if strip_particles and len(t) > 1:
                for p in sorted(self._PARTICLES, key=len, reverse=True):
                    if t.endswith(p) and len(t) > len(p):
                        t = t[:-len(p)]
                        break
            tokens.append(t)
        super().__init__(tokens)


class ChineseTokenizer(Tokenizer):
    """reference: deeplearning4j-nlp (ChineseTokenizer.java in later
    versions). Han runs split per character; other scripts by run."""

    def __init__(self, text):
        tokens = []
        for tok, script in _script_runs(text):
            if script == "han":
                tokens.extend(list(tok))
            else:
                tokens.append(tok)
        super().__init__(tokens)


class JapaneseTokenizerFactory(TokenizerFactory):
    def __init__(self, attach_okurigana=True):
        self._pre = None
        self.attach_okurigana = attach_okurigana

    def create(self, text):
        t = JapaneseTokenizer(text, self.attach_okurigana)
        t._pre = self._pre
        return t


class KoreanTokenizerFactory(TokenizerFactory):
    def __init__(self, strip_particles=True):
        self._pre = None
        self.strip_particles = strip_particles

    def create(self, text):
        t = KoreanTokenizer(text, self.strip_particles)
        t._pre = self._pre
        return t


class ChineseTokenizerFactory(TokenizerFactory):
    def __init__(self):
        self._pre = None

    def create(self, text):
        t = ChineseTokenizer(text)
        t._pre = self._pre
        return t
