"""Porter stemmer — pure-Python implementation of the classic algorithm.

The port's copy of deeplearning4j_tpu/text/stemming.py, held against it by
tests/test_torch_text_nlp.py; the text below is the reference's.

TPU-native equivalent of the reference's stemming chain
(text/tokenization/tokenizer/preprocessor/StemmingPreprocessor.java, which
delegates to the tartarus snowball PorterStemmer shipped with Lucene).
Implements Porter's 1980 algorithm steps 1a-5b directly; no third-party
stemmer library exists in this environment.
"""
from __future__ import annotations

_VOWELS = set("aeiou")


def _is_consonant(word, i):
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem):
    """Porter's m: number of VC sequences in c*(VC)^m v*."""
    forms = []
    for i in range(len(stem)):
        forms.append("c" if _is_consonant(stem, i) else "v")
    s = "".join(forms)
    m = 0
    # collapse runs then count "vc" transitions
    collapsed = []
    for ch in s:
        if not collapsed or collapsed[-1] != ch:
            collapsed.append(ch)
    run = "".join(collapsed)
    for i in range(len(run) - 1):
        if run[i] == "v" and run[i + 1] == "c":
            m += 1
    return m


def _contains_vowel(stem):
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word):
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word):
    if len(word) < 3:
        return False
    return (_is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in "wxy")


def _replace(word, suffix, replacement, m_min):
    stem = word[:-len(suffix)]
    if _measure(stem) > m_min:
        return stem + replacement
    return word


def porter_stem(word):
    """Stem one lowercase word."""
    w = word
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif (w.endswith("ed") and _contains_vowel(w[:-2])) or \
         (w.endswith("ing") and _contains_vowel(w[:-3])):
        w = w[:-2] if w.endswith("ed") else w[:-3]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    for suffix, rep in (("ational", "ate"), ("tional", "tion"),
                        ("enci", "ence"), ("anci", "ance"), ("izer", "ize"),
                        ("abli", "able"), ("alli", "al"), ("entli", "ent"),
                        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
                        ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
                        ("iveness", "ive"), ("fulness", "ful"),
                        ("ousness", "ous"), ("aliti", "al"),
                        ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suffix):
            w = _replace(w, suffix, rep, 0)
            break

    # step 3
    for suffix, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                        ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                        ("ness", "")):
        if w.endswith(suffix):
            w = _replace(w, suffix, rep, 0)
            break

    # step 4
    for suffix in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                   "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                   "ive", "ize"):
        if w.endswith(suffix):
            stem = w[:-len(suffix)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and \
                _measure(w[:-3]) > 1:
            w = w[:-3]

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]
    return w


class StemmingPreprocessor:
    """CommonPreprocessor cleaning + Porter stemming — reference
    text/tokenization/tokenizer/preprocessor/StemmingPreprocessor.java."""

    def __init__(self):
        from .tokenization import CommonPreprocessor
        self._common = CommonPreprocessor()

    def pre_process(self, token):
        return porter_stem(self._common.pre_process(token))

    preProcess = pre_process
