"""Mecab/IPADIC-format dictionary ingestion for the Japanese lattice.

The port's copy of deeplearning4j_tpu/text/ja_dictionary.py, held against it
by tests/test_torch_cjk.py; the text below is the reference's.

The reference VENDORS a full dictionary pipeline — CSV parsing
(kuromoji/util/DictionaryEntryLineParser.java), dictionary compile
(kuromoji/ipadic/compile/DictionaryCompiler.java: token-info CSVs +
matrix.def + char.def + unk.def -> binary buffers), trie build
(kuromoji/trie/), user dictionaries (kuromoji/dict/UserDictionary.java) and
Viterbi over left/right connection ids (kuromoji/viterbi/). The builtin
lexicon (`ja_lexicon`) covers the no-data-available case; THIS module is the
ingestion path those offline constraints don't excuse: point it at any
mecab-format dictionary (IPADIC, NAIST-jdic, unidic-style CSVs) and the
lattice runs on it.

Formats (all standard mecab, parsed format-exactly):

  * token CSVs — ``surface,left_id,right_id,cost,pos1,pos2,pos3,pos4,
    conj_type,conj_form,base,reading,pronunciation`` with RFC-style quoting
    (a field may be ``"``-quoted to contain commas; ``""`` escapes a quote)
    — the DictionaryEntryLineParser contract.
  * ``matrix.def`` — header ``<forward_size> <backward_size>``, then lines
    ``right_id left_id cost``: the cost of joining a morpheme whose
    right_id is the first number to a following morpheme whose left_id is
    the second.
  * ``char.def`` — category definitions ``NAME invoke group length`` and
    code-point mappings ``0xXXXX[..0xYYYY] NAME [NAME2...]``.
  * ``unk.def`` — mecab CSV whose surface column is a char.def category:
    the unknown-word templates per category.
  * user dictionaries — the simplified Kuromoji format
    ``surface,space-separated segments,space-separated readings,pos``.

`compile_dictionary` returns a `MecabDictionary`; `save_compiled` /
`load_compiled` round-trip the compiled form (one JSON + the cost matrix as
a flat list — the TokenInfoDictionaryCompiler artifact role, without the
unportable binary layout).
"""
from __future__ import annotations

import json
import os

import numpy as np

from .cjk_tokenization import _script

# user-dictionary entries must beat any lexical candidate; Kuromoji uses a
# large negative word cost for the same reason (UserDictionary.java
# WORD_COST)
USER_DICT_COST = -100000
_DEFAULT_UNK_COST = 4000


def parse_entry_line(line):
    """Split one mecab CSV line into fields, honoring quoting: a field may
    be wrapped in double quotes to contain commas, and `""` inside a quoted
    field is a literal quote (DictionaryEntryLineParser.java behavior)."""
    fields, cur, quoted = [], [], False
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if quoted:
            if c == '"':
                if i + 1 < n and line[i + 1] == '"':
                    cur.append('"')
                    i += 1
                else:
                    quoted = False
            else:
                cur.append(c)
        elif c == '"' and not cur:
            quoted = True
        elif c == ",":
            fields.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    if quoted:
        raise ValueError(f"unmatched quote in dictionary line: {line!r}")
    fields.append("".join(cur))
    return fields


class ConnectionCosts:
    """matrix.def: cost[right_id of previous, left_id of next]."""

    def __init__(self, forward_size, backward_size, costs):
        self.forward_size = int(forward_size)
        self.backward_size = int(backward_size)
        self._m = costs                       # np.int32 [forward, backward]

    @classmethod
    def parse(cls, text):
        lines = [l for l in (l.strip() for l in text.splitlines()) if l]
        f, b = (int(x) for x in lines[0].split())
        m = np.zeros((f, b), np.int32)
        for l in lines[1:]:
            r, lft, c = (int(x) for x in l.split())
            m[r, lft] = c
        return cls(f, b, m)

    def cost(self, right_id, left_id):
        if 0 <= right_id < self.forward_size and \
                0 <= left_id < self.backward_size:
            return int(self._m[right_id, left_id])
        return 0


class CharacterDefinitions:
    """char.def: code point -> category, and per-category unknown-word
    invocation flags (invoke, group, length) —
    kuromoji/dict/CharacterDefinitions.java role."""

    def __init__(self, categories, ranges):
        self.categories = categories          # name -> (invoke, group, len)
        self._ranges = ranges                 # list of (lo, hi, [names])

    @classmethod
    def parse(cls, text):
        categories, ranges = {}, []
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if parts[0].startswith("0x"):
                cps = parts[0].split("..")
                lo = int(cps[0], 16)
                hi = int(cps[1], 16) if len(cps) > 1 else lo
                ranges.append((lo, hi, parts[1:]))
            elif len(parts) >= 4:
                categories[parts[0]] = (int(parts[1]), int(parts[2]),
                                        int(parts[3]))
        return cls(categories, ranges)

    def lookup(self, ch):
        """Primary category name for a character (DEFAULT fallback)."""
        cp = ord(ch)
        for lo, hi, names in self._ranges:
            if lo <= cp <= hi:
                return names[0]
        return "DEFAULT"


# builtin script-class -> pseudo category used when char.def is absent
# (the curated-lexicon unknown model keeps working on real dictionaries
# shipped without that file)
_FALLBACK_FLAGS = {"katakana": (1, 1, 0), "latin": (1, 1, 0),
                   "digit": (1, 1, 0), "hangul": (1, 1, 0),
                   "han": (0, 0, 3), "hiragana": (0, 0, 3),
                   "other": (0, 0, 2)}

# script-class -> the standard mecab char.def category name, so a
# dictionary shipping unk.def WITHOUT char.def still has its unknown
# templates honored (unk.def surfaces use the uppercase category names)
_FALLBACK_UNK_CATEGORY = {"katakana": "KATAKANA", "latin": "ALPHA",
                          "digit": "NUMERIC", "han": "KANJI",
                          "hiragana": "HIRAGANA", "hangul": "HANGUL",
                          "other": "DEFAULT"}


class MecabDictionary:
    """Compiled dictionary: surface trie + ids + features + connection
    matrix + unknown templates. The lattice consumes `candidates`, `conn`
    and `unknown_candidates`; everything else is lookup metadata."""

    def __init__(self, entries, conn, char_defs=None, unk_entries=None):
        # entries: (surface, left_id, right_id, cost, features-tuple,
        #           segments|None)
        self.entries = entries
        self.conn = conn
        self.char_defs = char_defs
        self.unk_entries = unk_entries or {}
        self.root = {}
        for idx, e in enumerate(entries):
            node = self.root
            for ch in e[0]:
                node = node.setdefault(ch, {})
            node.setdefault(None, []).append(idx)

    # -- lattice interface -------------------------------------------------
    def candidates(self, text, start):
        """Entry indices (into `self.entries`) of every dictionary surface
        starting at text[start]."""
        node, out = self.root, []
        for i in range(start, len(text)):
            node = node.get(text[i])
            if node is None:
                break
            for idx in node.get(None, ()):
                out.append(idx)
        return out

    def unknown_candidates(self, text, start, had_dict_match):
        """Unknown-word entries at `start` per char.def/unk.def semantics:
        category's `invoke`=1 proposes unknowns even beside dictionary
        matches; `group`=1 takes the whole same-category run; `length`>0
        proposes 1..length prefixes. Without char.def, the builtin script
        classes stand in. Returns [(surface, left, right, cost, features)]
        — ALWAYS >=1 when no dictionary match, so the lattice connects."""
        if self.char_defs is not None:
            cat = self.char_defs.lookup(text[start])
            invoke, group, length = self.char_defs.categories.get(
                cat, (0, 1, 0))
            run = self._run(text, start,
                            lambda ch: self.char_defs.lookup(ch) == cat)
        else:
            script = _script(text[start])
            invoke, group, length = _FALLBACK_FLAGS.get(
                script, _FALLBACK_FLAGS["other"])
            run = self._run(text, start, lambda ch: _script(ch) == script)
            # unk.def (if shipped without char.def) keys by the standard
            # uppercase category names
            cat = _FALLBACK_UNK_CATEGORY.get(script, "DEFAULT")
        if had_dict_match and not invoke:
            return []
        templates = self.unk_entries.get(cat) or [
            (0, 0, _DEFAULT_UNK_COST,
             ("未知語", "*", "*", "*", "*", "*", "*", "*", "*"))]
        out = []
        lengths = []
        if group:
            lengths.append(run)
        lengths.extend(range(1, min(run, length) + 1))
        for ln in sorted(set(lengths)):
            surface = text[start:start + ln]
            for left, right, cost, feats in templates:
                out.append((surface, left, right,
                            cost + 1000 * max(0, ln - 1), feats))
        return out

    @staticmethod
    def _run(text, start, pred):
        n = start
        while n < len(text) and pred(text[n]):
            n += 1
        return n - start

    # -- compiled-artifact round trip -------------------------------------
    def save_compiled(self, path):
        """One-file compiled artifact (DictionaryCompiler output role)."""
        doc = {
            "entries": [list(e[:4]) + [list(e[4]),
                                       list(e[5]) if e[5] else None]
                        for e in self.entries],
            "conn": {"f": self.conn.forward_size,
                     "b": self.conn.backward_size,
                     "m": self.conn._m.ravel().tolist()},
            "char_defs": (None if self.char_defs is None else
                          {"categories": self.char_defs.categories,
                           "ranges": self.char_defs._ranges}),
            "unk": {k: [list(t[:3]) + [list(t[3])] for t in v]
                    for k, v in self.unk_entries.items()},
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False)

    @classmethod
    def load_compiled(cls, path):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        entries = [(e[0], e[1], e[2], e[3], tuple(e[4]),
                    tuple(e[5]) if e[5] else None)
                   for e in doc["entries"]]
        conn = ConnectionCosts(
            doc["conn"]["f"], doc["conn"]["b"],
            np.asarray(doc["conn"]["m"], np.int32).reshape(
                doc["conn"]["f"], doc["conn"]["b"]))
        cd = None
        if doc["char_defs"] is not None:
            cd = CharacterDefinitions(
                {k: tuple(v) for k, v in
                 doc["char_defs"]["categories"].items()},
                [(r[0], r[1], r[2]) for r in doc["char_defs"]["ranges"]])
        unk = {k: [(t[0], t[1], t[2], tuple(t[3])) for t in v]
               for k, v in doc["unk"].items()}
        return cls(entries, conn, cd, unk)


def _parse_token_csv(text, entries):
    # no comment syntax: mecab token CSVs can legitimately contain entries
    # whose surface IS '#' (symbol dictionaries) — only blanks are skipped
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        f = parse_entry_line(line)
        if len(f) < 4:
            raise ValueError(f"short dictionary line: {line!r}")
        entries.append((f[0], int(f[1]), int(f[2]), int(f[3]),
                        tuple(f[4:]), None))


def _parse_unk_def(text):
    unk = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        f = parse_entry_line(line)
        unk.setdefault(f[0], []).append(
            (int(f[1]), int(f[2]), int(f[3]), tuple(f[4:])))
    return unk


def parse_user_dictionary(text):
    """Kuromoji simplified user-dictionary format:
    ``surface,seg1 seg2...,read1 read2...,pos``. Each surface becomes ONE
    lattice entry (cost USER_DICT_COST, ids 0) that the tokenizer expands
    into its segments — the UserDictionary.java match behavior (関西国際空港
    reported as 関西|国際|空港)."""
    entries = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        f = parse_entry_line(line)
        if len(f) < 4:
            raise ValueError(f"short user dictionary line: {line!r}")
        surface, segs, readings, pos = f[0], f[1].split(), f[2].split(), f[3]
        if "".join(segs) != surface:
            raise ValueError(
                f"segments {segs} do not concatenate to {surface!r}")
        entries.append((surface, 0, 0, USER_DICT_COST,
                        (pos, "*", "*", "*", "*", "*", surface,
                         " ".join(readings), "*"),
                        tuple(segs)))
    return entries


def compile_dictionary(path, user_dict_path=None):
    """Compile a mecab-format dictionary directory (or a single token CSV
    file) into a MecabDictionary: every ``*.csv`` is a token-info file;
    ``matrix.def``, ``char.def``, ``unk.def`` are picked up when present
    (DictionaryCompiler.java pipeline)."""
    entries = []
    conn = ConnectionCosts(1, 1, np.zeros((1, 1), np.int32))
    char_defs, unk = None, {}
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            p = os.path.join(path, name)
            if name.endswith(".csv"):
                with open(p, encoding="utf-8") as f:
                    _parse_token_csv(f.read(), entries)
            elif name == "matrix.def":
                with open(p, encoding="utf-8") as f:
                    conn = ConnectionCosts.parse(f.read())
            elif name == "char.def":
                with open(p, encoding="utf-8") as f:
                    char_defs = CharacterDefinitions.parse(f.read())
            elif name == "unk.def":
                with open(p, encoding="utf-8") as f:
                    unk = _parse_unk_def(f.read())
    else:
        with open(path, encoding="utf-8") as f:
            _parse_token_csv(f.read(), entries)
    if not entries:
        raise ValueError(f"no dictionary entries found under {path!r}")
    if user_dict_path is not None:
        with open(user_dict_path, encoding="utf-8") as f:
            entries.extend(parse_user_dictionary(f.read()))
    return MecabDictionary(entries, conn, char_defs, unk)


def viterbi_segment_dict(text, dic):
    """Least-cost path over left/right connection ids (the ViterbiSearcher
    role, generalized from `ja_lattice.viterbi_segment`'s POS-keyed builtin
    lattice). Returns [(surface, features, segments|None)]."""
    n = len(text)
    if n == 0:
        return []
    # nodes_by_end[e] = (start, surface, left, right, word_cost, feats,
    #                    segments)
    nodes_by_end = [[] for _ in range(n + 1)]
    for i in range(n):
        idxs = dic.candidates(text, i)
        for idx in idxs:
            surface, left, right, cost, feats, segs = dic.entries[idx]
            nodes_by_end[i + len(surface)].append(
                (i, surface, left, right, cost, feats, segs))
        for surface, left, right, cost, feats in dic.unknown_candidates(
                text, i, bool(idxs)):
            nodes_by_end[i + len(surface)].append(
                (i, surface, left, right, cost, feats, None))
    # best[i][right_id] = (cost, node, prev_right_id); BOS/EOS id 0
    best = [dict() for _ in range(n + 1)]
    best[0][0] = (0, None, None)
    for e in range(1, n + 1):
        for node in nodes_by_end[e]:
            s, surface, left, right, wcost, feats, segs = node
            if not best[s]:
                continue
            cost, prev_right = min(
                ((pc + dic.conn.cost(pright, left) + wcost, pright)
                 for pright, (pc, _, _) in best[s].items()),
                key=lambda t: t[0])
            cur = best[e].get(right)
            if cur is None or cost < cur[0]:
                best[e][right] = (cost, node, prev_right)
    if not best[n]:                      # unknowns guarantee connectivity
        return [(text, ("未知語",), None)]
    end_right = min(best[n], key=lambda r: best[n][r][0]
                    + dic.conn.cost(r, 0))
    out = []
    e, right = n, end_right
    while e > 0:
        _, node, prev_right = best[e][right]
        s, surface, _, _, _, feats, segs = node
        out.append((surface, feats, segs))
        e, right = s, prev_right
    out.reverse()
    return out
