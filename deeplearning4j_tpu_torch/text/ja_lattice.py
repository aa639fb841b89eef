"""Japanese lattice tokenizer — trie dictionary + Viterbi least-cost path.

The port's copy of deeplearning4j_tpu/text/ja_lattice.py, held against it by
tests/test_torch_cjk.py; the text below is the reference's.

The Kuromoji shape (reference: deeplearning4j-nlp-japanese/src/main/java/
com/atilika/kuromoji/trie/PatriciaTrie.java + viterbi/ViterbiSearcher.java,
~6k LoC vendored) at small scale:

  1. a char trie over the committed lexicon (`ja_lexicon.build_entries`,
     several thousand surface forms from curated lemmas + conjugation
     expansion),
  2. an unknown-word model by script class (katakana/latin/digit runs
     group whole; kanji/hiragana get per-length penalized candidates —
     Kuromoji's CharacterDefinition role), which also guarantees the
     lattice always has a path,
  3. a small POS-pair connection-cost matrix (the ConnectionCosts matrix
     role, hand-sized instead of IPADIC's 1316×1316),
  4. Viterbi: min (word costs + connection costs) over the lattice.

Spaceless text segments correctly where script-transition splitting
cannot: すもももももももものうち -> すもも|も|もも|も|もも|の|うち
(script classes never change, so `JapaneseTokenizer` yields ONE token).
"""
from __future__ import annotations

import re

from .cjk_tokenization import _script
from .ja_lexicon import build_entries
from .tokenization import Tokenizer, TokenizerFactory

# --- connection costs: conn[prev_pos][next_pos] --------------------------
# Low where Japanese syntax welcomes the transition (noun -> particle),
# high where a boundary is implausible (particle -> particle is usually a
# missed compound particle). "bos"/"eos" row/col = sentence boundary.
_POS = ("noun", "pron", "verb", "adj", "adv", "particle", "aux", "unk",
        "bos", "eos")
_DEF = 700
_CONN = {p: dict.fromkeys(_POS, _DEF) for p in _POS}


def _set(prev, nxt, cost):
    _CONN[prev][nxt] = cost


for _p in ("noun", "pron"):
    _set(_p, "particle", 0)          # 学校|に, 私|は
    _set(_p, "aux", 200)             # 学生|です
    _set(_p, "noun", 800)            # compounds exist but prefer particles
    _set(_p, "verb", 900)            # usually a particle intervenes
    _set(_p, "eos", 400)
_set("particle", "noun", 100)        # は|学校
_set("particle", "pron", 150)
_set("particle", "verb", 100)        # を|食べた
_set("particle", "adj", 200)
_set("particle", "adv", 300)
_set("particle", "particle", 1000)   # compound particles are lexicon entries
_set("particle", "unk", 300)
_set("particle", "eos", 600)         # sentence-final か/よ/ね are fine-ish
_set("verb", "particle", 250)        # 食べて|は
_set("verb", "aux", 100)             # 食べ|ない handled in lexicon; 行く|らしい
_set("verb", "noun", 500)            # relative clause 食べた|人
_set("verb", "pron", 550)
_set("verb", "eos", 150)
_set("adj", "noun", 200)             # 高い|山
_set("adj", "aux", 250)
_set("adj", "particle", 350)
_set("adj", "eos", 300)
_set("adv", "verb", 200)
_set("adv", "adj", 300)
_set("aux", "eos", 100)
_set("aux", "particle", 500)
_set("bos", "noun", 100)
_set("bos", "pron", 100)
_set("bos", "adv", 200)
_set("bos", "verb", 400)
_set("bos", "adj", 300)
_set("bos", "particle", 1200)        # sentences rarely open with a particle
_set("unk", "particle", 150)         # unknown noun-ish + particle is normal
_set("unk", "aux", 400)
_set("unk", "eos", 500)
_set("unk", "unk", 900)


class _Trie:
    __slots__ = ("root",)

    def __init__(self, entries):
        self.root = {}
        for surface, pos, cost in entries:
            node = self.root
            for ch in surface:
                node = node.setdefault(ch, {})
            # terminal marker: list of (surface, pos, cost) readings
            node.setdefault(None, []).append((surface, pos, cost))

    def prefixes(self, text, start):
        """All dictionary entries starting at text[start]."""
        node = self.root
        out = []
        for i in range(start, len(text)):
            node = node.get(text[i])
            if node is None:
                break
            if None in node:
                out.extend(node[None])
        return out


_TRIE = None


def _trie():
    global _TRIE
    if _TRIE is None:
        _TRIE = _Trie(build_entries())
    return _TRIE


# --- unknown-word model --------------------------------------------------
# (cost_base, cost_per_extra_char, max_len, group_whole_run)
_UNK = {
    "katakana": (2200, 10, 0, True),    # loanwords: take the whole run
    "latin": (1600, 5, 0, True),
    "digit": (1500, 5, 0, True),
    "han": (4000, 2200, 3, False),      # unknown kanji compounds, 1-3 chars
    "hiragana": (6000, 3500, 3, False),  # strongly prefer the dictionary
    "hangul": (2500, 10, 0, True),
    "other": (5000, 2000, 2, False),
}


def _run_len(text, start, script):
    n = start
    while n < len(text) and _script(text[n]) == script:
        n += 1
    return n - start


def _unknown_nodes(text, start):
    """Unknown-word candidates at `start` — guarantees ≥1 node per
    position so the lattice always connects."""
    script = _script(text[start])
    base, per, max_len, whole = _UNK.get(script, _UNK["other"])
    run = _run_len(text, start, script)
    out = []
    if whole:
        out.append((text[start:start + run], "unk", base + per * (run - 1)))
    else:
        for ln in range(1, min(run, max_len) + 1):
            out.append((text[start:start + ln], "unk",
                        base + per * (ln - 1)))
    return out


def viterbi_segment(text):
    """Least-cost segmentation of one spaceless chunk.
    Returns list of (surface, pos)."""
    n = len(text)
    if n == 0:
        return []
    trie = _trie()
    # nodes[e] = list of (start, surface, pos, total_word_cost)
    nodes_by_end = [[] for _ in range(n + 1)]
    for i in range(n):
        cands = trie.prefixes(text, i)
        seen_len = {len(s) for s, _, _ in cands}
        for surface, pos, cost in cands:
            nodes_by_end[i + len(surface)].append((i, surface, pos, cost))
        for surface, pos, cost in _unknown_nodes(text, i):
            if len(surface) not in seen_len:
                nodes_by_end[i + len(surface)].append(
                    (i, surface, pos, cost))
    # best[i] = (cost, node, prev_best_key) for the best path covering
    # text[:i] ending with `node`; keyed per end position by POS so
    # connection costs stay exact
    best = [dict() for _ in range(n + 1)]       # pos -> (cost, node, ppos)
    best[0]["bos"] = (0, None, None)
    for e in range(1, n + 1):
        for (s, surface, pos, wcost) in nodes_by_end[e]:
            if not best[s]:
                continue
            cand = min(
                (pc + _CONN[ppos][pos] + wcost, ppos)
                for ppos, (pc, _, _) in best[s].items())
            cost, ppos = cand
            cur = best[e].get(pos)
            if cur is None or cost < cur[0]:
                best[e][pos] = (cost, (s, surface, pos), ppos)
    if not best[n]:      # cannot happen (unknown singles always connect)
        return [(text, "unk")]
    # add EOS connection and pick the best final POS
    end_pos = min(best[n],
                  key=lambda p: best[n][p][0] + _CONN[p]["eos"])
    # backtrack
    out = []
    e, pos = n, end_pos
    while e > 0:
        cost, node, ppos = best[e][pos]
        s, surface, npos = node
        out.append((surface, npos))
        e, pos = s, ppos
    out.reverse()
    return out


_SPLIT = re.compile(r"[\s。、．，！？!?,.「」『』（）()\[\]:;：；…・〜~]+")


# mecab pos1 -> the coarse tag set the builtin lattice uses, so pos_tags
# stays one vocabulary whichever dictionary backs the lattice
_MECAB_POS = {"名詞": "noun", "代名詞": "pron", "動詞": "verb",
              "形容詞": "adj", "副詞": "adv", "助詞": "particle",
              "助動詞": "aux", "接続詞": "conj", "連体詞": "adnominal",
              "感動詞": "interjection", "記号": "symbol",
              "接頭詞": "prefix", "フィラー": "filler", "未知語": "unk"}


class JapaneseLatticeTokenizer(Tokenizer):
    """Morphological tokenizer: trie + Viterbi over the committed lexicon
    (reference: JapaneseTokenizer.java backed by Kuromoji's
    ViterbiSearcher), or over a compiled mecab-format dictionary when
    `dictionary` is given (`ja_dictionary.compile_dictionary` — the
    Kuromoji DictionaryCompiler/UserDictionary ingestion path).
    Punctuation splits chunks; each chunk is segmented by least-cost
    lattice path. User-dictionary multi-segment entries are expanded into
    their segments (関西国際空港 -> 関西|国際|空港), the
    UserDictionary.java match shape."""

    def __init__(self, text, with_pos=False, dictionary=None):
        tokens = []
        self.pos_tags = []
        for chunk in _SPLIT.split(text):
            if not chunk:
                continue
            if dictionary is None:
                for surface, pos in viterbi_segment(chunk):
                    tokens.append(surface)
                    self.pos_tags.append(pos)
            else:
                from .ja_dictionary import viterbi_segment_dict
                for surface, feats, segs in viterbi_segment_dict(
                        chunk, dictionary):
                    pos = _MECAB_POS.get(feats[0] if feats else "",
                                         feats[0] if feats else "unk")
                    for seg in (segs or (surface,)):
                        tokens.append(seg)
                        self.pos_tags.append(pos)
        super().__init__(tokens)


class JapaneseLatticeTokenizerFactory(TokenizerFactory):
    """TokenizerFactory SPI over the lattice tokenizer — drop-in where
    `JapaneseTokenizerFactory` (script-transition baseline) was used.

    `dict_path`: mecab-format dictionary directory (token CSVs +
    matrix.def [+ char.def, unk.def]) or a single token CSV file;
    `user_dict_path`: Kuromoji-format user dictionary. Compiled once here,
    shared by every tokenizer the factory creates."""

    def __init__(self, dict_path=None, user_dict_path=None):
        self._pre = None
        self.dictionary = None
        if dict_path is not None:
            from .ja_dictionary import compile_dictionary
            self.dictionary = compile_dictionary(
                dict_path, user_dict_path=user_dict_path)
        elif user_dict_path is not None:
            raise ValueError("user_dict_path requires dict_path (user "
                             "entries extend a base dictionary)")

    def create(self, text):
        t = JapaneseLatticeTokenizer(text, dictionary=self.dictionary)
        t._pre = self._pre
        return t
