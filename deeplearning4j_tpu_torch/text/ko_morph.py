"""Korean morphological tokenizer — eojeol decomposition at small scale.

The port's copy of deeplearning4j_tpu/text/ko_morph.py, held against it by
tests/test_torch_cjk.py; the text below is the reference's.

TPU-native equivalent of reference deeplearning4j-nlp-korean (vendored
KoreanText analyzer, ~3k LoC + dictionaries). Korean text IS
space-segmented into eojeol (word units), but each eojeol agglutinates a
content stem with josa (case particles) and eomi (verb/adjective endings).
The vendored analyzer's dictionaries are unavailable offline; this module
implements the same DECOMPOSITION mechanism over committed closed-class
inventories — longest-match josa stripping with final-consonant (batchim)
agreement, and a conjugation-ending table that recovers verb stems
(했다 -> 하 + 였다, 먹었어요 -> 먹 + 었어요) — so downstream vocabularies
see stems and affixes as separate tokens, the KoreanTokenizer.java output
shape.
"""
from __future__ import annotations

import re

from .tokenization import Tokenizer, TokenizerFactory

_HANGUL_BASE = 0xAC00


def _decompose(ch):
    """Hangul syllable -> (lead, vowel, tail) jamo indices; None for
    non-syllables. tail 0 = no final consonant (no batchim)."""
    cp = ord(ch)
    if not (0xAC00 <= cp <= 0xD7A3):
        return None
    idx = cp - _HANGUL_BASE
    return idx // 588, (idx % 588) // 28, idx % 28


def _has_batchim(ch):
    d = _decompose(ch)
    return d is not None and d[2] != 0


# --- josa (case particles): (form, requires_batchim) -----------------
# requires_batchim: True = attaches after a final consonant (은/이/을/과),
# False = after a vowel (는/가/를/와), None = either. Longest match first.
_JOSA = [
    ("에서부터", None), ("으로부터", True), ("로부터", False),
    ("에게서", None), ("한테서", None), ("에서는", None), ("에서도", None),
    ("까지", None), ("부터", None), ("에서", None), ("에게", None),
    ("한테", None), ("처럼", None), ("보다", None), ("마다", None),
    ("조차", None), ("밖에", None), ("으로", True), ("로", False),
    ("과", True), ("와", False), ("은", True), ("는", False),
    ("이", True), ("가", False), ("을", True), ("를", False),
    ("의", None), ("에", None), ("도", None), ("만", None), ("께", None),
    ("이나", True), ("나", False), ("이란", True), ("란", False),
]

# --- eomi (verb/adjective endings), longest first; stripping one
# recovers the stem. 하/되 contractions handled separately. -------------
_EOMI = [
    "겠습니다", "었습니다", "았습니다", "습니다", "ㅂ니다",
    "었어요", "았어요", "였어요", "어요", "아요", "여요", "에요", "예요",
    "었다", "았다", "였다", "는다", "ㄴ다", "다",
    "었고", "았고", "고", "지만", "면서", "려고", "러",
    "어서", "아서", "여서", "니까", "으니까", "으면", "면",
    "세요", "으세요", "십시오", "으십시오", "자", "죠", "네요",
    "는", "은", "을", "ㄹ", "던", "기", "음", "ㅁ",
]

# contracted 하다-forms: surface -> (stem 하, ending)
_HA_CONTRACTIONS = {
    "했": ("하", "였"), "해": ("하", "여"),
}


def split_josa(eojeol):
    """(stem, josa | None): longest matching particle whose batchim
    requirement agrees with the stem's final syllable. The (으)로 pair is
    special: 로 follows vowel-final OR ㄹ-final stems (서울로), 으로 the
    other consonants."""
    for form, needs_batchim in _JOSA:
        if not eojeol.endswith(form) or len(eojeol) <= len(form):
            continue
        stem = eojeol[:-len(form)]
        if needs_batchim is not None:
            d = _decompose(stem[-1])
            if d is None:
                continue
            if form in ("로", "로부터"):
                if d[2] not in (0, 8):          # vowel or ㄹ final
                    continue
            elif (d[2] != 0) != needs_batchim:
                continue
        return stem, form
    return eojeol, None


def _strip_tail(ch):
    """Remove a syllable's final consonant: 갑 -> 가."""
    lead, vowel, _ = _decompose(ch)
    return chr(_HANGUL_BASE + lead * 588 + vowel * 28)


def split_eomi(word):
    """(stem, ending | None) for conjugated verbs/adjectives: undo the
    하다-contraction (했다 -> 하+였다) and the ㅂ니다 contraction
    (갑니다 -> 가+ㅂ니다), then longest-match the ending table.
    Single-syllable stems are accepted (먹다 -> 먹); bare nouns fall
    through unchanged."""
    for surf, (ha, tail) in _HA_CONTRACTIONS.items():
        i = word.find(surf)
        if i >= 0:
            rest = word[i + len(surf):]
            for e in _EOMI:
                if (tail + rest) == e or rest == e or (
                        not rest and tail in ("였", "여")):
                    return word[:i] + ha, (tail + rest) or tail
    candidates = []
    # ㅂ-irregular polite ending: X[ㅂ]니다 / X[ㅂ]니까 on a vowel stem
    # (가+ㅂ니다 = 갑니다); priority 0 — the regular 습니다 (consonant
    # stems) is a table entry and must win TIES (먹습니다 -> 먹+습니다,
    # never 먹스+ㅂ니다)
    for pol in ("니다", "니까"):
        if word.endswith(pol) and len(word) > len(pol):
            prev = word[-len(pol) - 1]
            d = _decompose(prev)
            if d is not None and d[2] == 17:            # ㅂ final
                stem = word[:-len(pol) - 1] + _strip_tail(prev)
                candidates.append((len(pol) + 1, 0, stem, "ㅂ" + pol))
    for e in sorted(_EOMI, key=len, reverse=True):
        if word.endswith(e) and len(word) > len(e):
            stem = word[:-len(e)]
            if all(_decompose(c) is not None for c in stem):
                candidates.append((len(e), 1, stem, e))
                break
    if candidates:
        _, _, stem, e = max(candidates, key=lambda c: (c[0], c[1]))
        return stem, e
    return word, None


class KoreanMorphTokenizer(Tokenizer):
    """Eojeol -> [stem, josa?, eomi?] morpheme stream (reference
    KoreanTokenizer.java backed by the vendored KoreanText analyzer;
    closed-class decomposition here). emit_affixes=False drops the
    particles/endings (bag-of-stems mode, what embedding vocabularies
    want).

    `dictionary` (a `ko_dictionary.KoreanDictionary`) is the open-class
    lexicon the analyzer consults: a known noun is never decomposed by the
    eomi heuristic (바다 stays 바다, not 바+다), and a known noun found
    under a josa confirms the particle split without further stripping —
    the role the vendored wordlist resources play."""

    def __init__(self, text, emit_affixes=True, dictionary=None):
        tokens = []
        for eojeol in re.split(r"[\s\W]+", text, flags=re.UNICODE):
            if not eojeol:
                continue
            if dictionary is not None and eojeol in dictionary.nouns:
                tokens.append(eojeol)
                continue
            stem, josa = split_josa(eojeol)
            if dictionary is not None and stem in dictionary.nouns:
                stem2, eomi = stem, None
            else:
                stem2, eomi = split_eomi(stem)
                if (dictionary is not None and eomi is not None
                        and stem2 not in dictionary.verbs
                        and stem in dictionary.verbs):
                    # the un-split form is a known stem but the split
                    # result is not: trust the dictionary over the
                    # heuristic (stem-in-nouns was handled above)
                    stem2, eomi = stem, None
            tokens.append(stem2)
            if emit_affixes:
                if eomi:
                    tokens.append(eomi)
                if josa:
                    tokens.append(josa)
        super().__init__(tokens)


class KoreanMorphTokenizerFactory(TokenizerFactory):
    """`dict_path`: KoreanText-layout wordlist directory (see
    `ko_dictionary.load_dictionary`), loaded once and shared by every
    tokenizer the factory creates."""

    def __init__(self, emit_affixes=True, dict_path=None, dictionary=None):
        self._pre = None
        self.emit_affixes = emit_affixes
        if dict_path is not None:
            from .ko_dictionary import load_dictionary
            dictionary = load_dictionary(dict_path)
        self.dictionary = dictionary

    def create(self, text):
        t = KoreanMorphTokenizer(text, self.emit_affixes,
                                 dictionary=self.dictionary)
        t._pre = self._pre
        return t
