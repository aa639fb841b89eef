"""WordVectorSerializer — persistence for embedding models.

The port's copy of deeplearning4j_tpu/models/embeddings/serializer.py
(numpy): each format's bytes are held equal to the reference's, and each
package reads the other's files (tests/test_torch_embeddings.py); the text
below is the reference's.

TPU-native equivalent of reference
models/embeddings/loader/WordVectorSerializer.java:88: read/write the Google
word2vec text and binary formats (plain or gzip — the reference's
loadTxtVectors sniffs the GZIP magic the same way), ParagraphVectors
persistence with the label space preserved (writeParagraphVectors /
readParagraphVectors), GloVe text export, plus a zip container (vocab json
+ vectors npz) standing in for the reference's DL4J zip formats.
"""
from __future__ import annotations

import gzip
import io
import json
import struct
import zipfile

import numpy as np

from ..word2vec.vocab import VocabCache, build_huffman
from .lookup_table import InMemoryLookupTable


def _open_text(path, mode):
    """Text open with transparent gzip by extension on write and by magic
    on read (reference: WordVectorSerializer's GZIP sniffing)."""
    path = str(path)
    if "r" in mode:
        with open(path, "rb") as fh:
            magic = fh.read(2)
        if magic == b"\x1f\x8b":
            return gzip.open(path, "rt", encoding="utf-8")
        return open(path, "r", encoding="utf-8")
    if path.endswith(".gz"):
        return gzip.open(path, "wt", encoding="utf-8")
    return open(path, "w", encoding="utf-8")


# ---------------------------------------------------------------------------
# Google word2vec text format: "V D\nword v1 v2 ...\n"
# ---------------------------------------------------------------------------

def write_word2vec_text(model, path):
    """reference: WordVectorSerializer.writeWordVectors (text; .gz path
    compresses, the reference's GZIP variant)."""
    vocab, lookup = model.vocab, model.lookup
    with _open_text(path, "w") as fh:
        fh.write(f"{len(vocab)} {lookup.vector_length}\n")
        for vw in vocab.vocab_words():
            vec = " ".join(f"{x:.6f}" for x in lookup.syn0[vw.index])
            fh.write(f"{vw.word} {vec}\n")


writeWordVectors = write_word2vec_text


def read_word2vec_text(path):
    """reference: WordVectorSerializer.loadTxtVectors (gzip auto-detected
    by magic)."""
    with _open_text(path, "r") as fh:
        header = fh.readline().split()
        V, D = int(header[0]), int(header[1])
        vocab = VocabCache()
        vectors = np.zeros((V, D), np.float32)
        for i in range(V):
            parts = fh.readline().rstrip("\n").split(" ")
            word = parts[0]
            vectors[i] = [float(x) for x in parts[1:D + 1]]
            vw = vocab.add_token(word, max(V - i, 1))  # preserve rank order
    vocab.finish()
    lookup = InMemoryLookupTable(vocab, D)
    lookup.syn0 = vectors
    return _as_static_model(vocab, lookup)


loadTxtVectors = read_word2vec_text


# ---------------------------------------------------------------------------
# Google word2vec binary format: "V D\n(word ' ' float32*D)*"
# ---------------------------------------------------------------------------

def write_word2vec_binary(model, path):
    """reference: WordVectorSerializer.writeWord2VecModel (binary)."""
    vocab, lookup = model.vocab, model.lookup
    with open(path, "wb") as fh:
        fh.write(f"{len(vocab)} {lookup.vector_length}\n".encode())
        for vw in vocab.vocab_words():
            fh.write(vw.word.encode("utf-8") + b" ")
            fh.write(np.asarray(lookup.syn0[vw.index],
                                np.float32).tobytes())
            fh.write(b"\n")


def read_word2vec_binary(path):
    """reference: WordVectorSerializer.loadGoogleModel (binary=true)."""
    with open(path, "rb") as fh:
        header = fh.readline().split()
        V, D = int(header[0]), int(header[1])
        vocab = VocabCache()
        vectors = np.zeros((V, D), np.float32)
        for i in range(V):
            word = bytearray()
            while True:
                ch = fh.read(1)
                if ch == b" " or ch == b"":
                    break
                if ch != b"\n":
                    word.extend(ch)
            vectors[i] = np.frombuffer(fh.read(4 * D), np.float32)
            nl = fh.read(1)
            if nl not in (b"\n", b""):
                fh.seek(-1, io.SEEK_CUR)
            vocab.add_token(word.decode("utf-8"), max(V - i, 1))
    vocab.finish()
    lookup = InMemoryLookupTable(vocab, D)
    lookup.syn0 = vectors
    return _as_static_model(vocab, lookup)


loadGoogleModel = read_word2vec_binary


# ---------------------------------------------------------------------------
# Full-model zip (vocab + syn0/syn1/syn1neg + hyperparameters)
# ---------------------------------------------------------------------------

def write_full_model(model, path):
    """Zip with vocab.json + weights.npz + config.json — the stand-in for the
    reference's DL4J zip format (WordVectorSerializer.writeFullModel)."""
    vocab, lookup = model.vocab, model.lookup
    vocab_json = [{"word": w.word, "count": w.count}
                  for w in vocab.vocab_words()]
    cfg = {"vectorLength": lookup.vector_length,
           "negative": lookup.negative, "useHs": lookup.use_hs}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("vocab.json", json.dumps(vocab_json))
        zf.writestr("config.json", json.dumps(cfg))
        buf = io.BytesIO()
        arrays = {"syn0": lookup.syn0}
        if lookup.syn1 is not None:
            arrays["syn1"] = lookup.syn1
        if lookup.syn1neg is not None:
            arrays["syn1neg"] = lookup.syn1neg
        np.savez(buf, **arrays)
        zf.writestr("weights.npz", buf.getvalue())


writeFullModel = write_full_model


def read_full_model(path):
    """reference: WordVectorSerializer.loadFullModel."""
    with zipfile.ZipFile(path, "r") as zf:
        vocab_json = json.loads(zf.read("vocab.json"))
        cfg = json.loads(zf.read("config.json"))
        weights = np.load(io.BytesIO(zf.read("weights.npz")))
        vocab = VocabCache()
        for item in vocab_json:
            vocab.add_token(item["word"], item["count"])
        vocab.finish()
        if cfg.get("useHs"):
            build_huffman(vocab)
        lookup = InMemoryLookupTable(vocab, int(cfg["vectorLength"]),
                                     negative=int(cfg.get("negative", 0)),
                                     use_hs=bool(cfg.get("useHs", True)))
        lookup.syn0 = weights["syn0"]
        if "syn1" in weights:
            lookup.syn1 = weights["syn1"]
        if "syn1neg" in weights:
            lookup.syn1neg = weights["syn1neg"]
        if lookup.negative > 0:
            # weights were assigned directly (no reset_weights), so the
            # unigram sampling table must be built here or training-style
            # code (infer_vector) dereferences neg_table=None
            lookup._build_neg_table()
    return _as_static_model(vocab, lookup)


loadFullModel = read_full_model


# ---------------------------------------------------------------------------
# ParagraphVectors persistence (labels are pseudo-words in the same
# vocab/lookup; the label LIST must round-trip so inference + nearest-label
# queries work after load)
# ---------------------------------------------------------------------------

def write_paragraph_vectors(pv, path):
    """reference: WordVectorSerializer.writeParagraphVectors — the full
    zip plus labels.json recording which vocab entries are labels."""
    write_full_model(pv, path)
    labels = list(pv.labels_source.get_labels())
    with zipfile.ZipFile(path, "a", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("labels.json", json.dumps(labels))


writeParagraphVectors = write_paragraph_vectors


def read_paragraph_vectors(path):
    """reference: WordVectorSerializer.readParagraphVectors — restores
    the training hyperparameters (use_hs/negative) from config.json so a
    negative-sampling model infers with the negative path, not a crashed
    HS default."""
    from ...text.sentence_iterator import LabelsSource
    from ..paragraphvectors.paragraph_vectors import ParagraphVectors
    base = read_full_model(path)
    with zipfile.ZipFile(path, "r") as zf:
        labels = json.loads(zf.read("labels.json"))
        cfg = json.loads(zf.read("config.json"))
    b = (ParagraphVectors.Builder()
         .layer_size(base.lookup.vector_length))
    if int(cfg.get("negative", 0)) > 0:
        b = b.negative_sample(int(cfg["negative"]))
    pv = b.build()
    pv.use_hs = bool(cfg.get("useHs", True))
    pv.vocab = base.vocab
    pv.lookup = base.lookup
    pv.labels_source = LabelsSource(labels=labels)
    return pv


readParagraphVectors = read_paragraph_vectors


def write_glove_text(glove, path):
    """reference: WordVectorSerializer.writeWordVectors(Glove) — the same
    text dialect over the summed W + Wc table."""
    write_word2vec_text(glove, path)


def _as_static_model(vocab, lookup):
    """Read-only model wrapper (reference: StaticWord2Vec — query-only use)."""
    from ..sequencevectors.sequence_vectors import SequenceVectors
    m = SequenceVectors(vector_length=lookup.vector_length)
    m.vocab = vocab
    m.lookup = lookup
    return m
