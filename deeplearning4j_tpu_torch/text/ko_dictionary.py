"""Korean dictionary loading for the morphological tokenizer.

The port's copy of deeplearning4j_tpu/text/ko_dictionary.py, held against it
by tests/test_torch_cjk.py; the text below is the reference's.

The reference wraps the KoreanText analyzer
(deeplearning4j-nlp-korean/.../KoreanTokenizer.java), whose lexicon ships
as per-category wordlist resources (noun/nouns.txt, verb/verb.txt, ...)
plus a runtime `addNounsToDictionary` user extension API. `ko_morph`
implements the decomposition mechanism over closed-class inventories; THIS
module is the open-class dictionary that mechanism consults:

  * `load_dictionary(path)` reads a directory of ``<category>.txt``
    wordlists (one word per line, ``#`` comments) — the KoreanText
    resource layout. Category = file stem (``noun.txt``/``nouns.txt`` ->
    nouns; ``verb.txt`` -> verb stems; anything else kept under its own
    name).
  * `KoreanDictionary.add_words` is the addNounsToDictionary role: extend
    any category at runtime (user dictionaries).

A known noun suppresses the heuristic eomi split (바다 stays 바다, never
바+다), and a known verb stem confirms a conjugation split — see
`KoreanMorphTokenizer(dictionary=...)`.
"""
from __future__ import annotations

import os

_NOUN_ALIASES = {"noun", "nouns", "propernoun", "propernouns"}
_VERB_ALIASES = {"verb", "verbs"}
_ADJ_ALIASES = {"adjective", "adjectives", "adj"}


class KoreanDictionary:
    def __init__(self):
        self.nouns = set()
        self.verbs = set()          # stems (dictionary form minus 다)
        self.categories = {}        # raw category name -> set(words)

    def add_words(self, category, words):
        """Runtime extension (KoreanText addNounsToDictionary parity):
        category is a wordlist name — noun/verb aliases feed the split
        logic, anything else is kept queryable under its own name."""
        cat = category.lower()
        bucket = self.categories.setdefault(cat, set())
        for w in words:
            w = w.strip()
            if not w or w.startswith("#"):
                continue
            bucket.add(w)
            if cat in _NOUN_ALIASES:
                self.nouns.add(w)
            elif cat in _VERB_ALIASES or cat in _ADJ_ALIASES:
                # dictionary form 먹다 -> stem 먹 (the analyzer consults
                # stems); bare stems are accepted as-is
                self.verbs.add(w[:-1] if w.endswith("다") and len(w) > 1
                               else w)
        return self

    def words(self, category):
        return frozenset(self.categories.get(category.lower(), ()))


def load_dictionary(path):
    """Load a KoreanText-layout dictionary directory: every ``*.txt`` is a
    category wordlist named by its file stem."""
    dic = KoreanDictionary()
    if not os.path.isdir(path):
        raise ValueError(f"not a dictionary directory: {path!r}")
    found = False
    for name in sorted(os.listdir(path)):
        if not name.endswith(".txt"):
            continue
        with open(os.path.join(path, name), encoding="utf-8") as f:
            dic.add_words(os.path.splitext(name)[0], f.read().splitlines())
        found = True
    if not found:
        raise ValueError(f"no *.txt wordlists under {path!r}")
    return dic
