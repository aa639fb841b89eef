"""ctypes binding to the native runtime library (native/dl4j_tpu_native.cpp).

The port's own loader for the C++ source the JAX package's
`common/native_ops.py` binds: IDX parsing, numeric CSV parsing, and the host
halves of the embeddings path (word2vec skip-gram pairs, CBOW context rows,
GloVe co-occurrence counts). The argument types and the ABI check are the
reference's; the wrappers return the same arrays (tests/test_torch_native_ops.py).

The library is compiled at first use, from the source in the checkout, with
`$CXX` (default `g++`) and the flags of `native/Makefile`, into the ignored
`build/native/` at the root of the checkout. Its name carries a hash of the
source and the flags. Each build writes a name of its own (the process id)
and renames it into place, so processes that build at once (test workers,
the reference's loader building into `native/`) never load a half-written
library. Every caller has a Python fallback (the reference's): without a
compiler the wrappers return None and the caller takes it.

Not bound here: the staging pool, the threaded CSV loader and the t-SNE
forces (ROADMAP.md queue 1 item 22).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dl4j_tpu_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_ABI_VERSION = 7  # must match dl4j_abi_version() in dl4j_tpu_native.cpp

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the library built from the checkout's source lives."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdl4j_tpu_native-{digest.hexdigest()[:16]}.so"


def _try_build(out: Path):
    """Compile the source into `out`; leaves `out` absent on failure."""
    global _build_attempted
    if _build_attempted:
        return
    _build_attempted = True
    cxx = os.environ.get("CXX") or "g++"
    if not SOURCE.exists() or shutil.which(cxx) is None:
        log.debug("no %s or no compiler %s; using python fallbacks",
                  SOURCE, cxx)
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except Exception as e:  # toolchain missing / build failure -> fallback
        log.debug("native build failed (%s); using python fallbacks", e)
        tmp.unlink(missing_ok=True)


def _load_checked(path: Path):
    """CDLL + ABI version check; None if missing or mismatched."""
    if not path.exists():
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.dl4j_abi_version.restype = ctypes.c_int64
        if lib.dl4j_abi_version() != _ABI_VERSION:
            return None
    except (OSError, AttributeError):
        return None
    return lib


def get_lib():
    """The loaded native library (built first if absent), or None."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not SOURCE.exists():
            return None
        path = library_path()
        lib = _load_checked(path)
        if lib is None:
            _try_build(path)
            lib = _load_checked(path)
        if lib is None:
            return None
        lib.dl4j_read_idx_u8.restype = _f32p
        lib.dl4j_read_idx_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_double, _i32p, _i64p, _i64p]
        lib.dl4j_parse_csv.restype = _f32p
        lib.dl4j_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int64, _i64p, _i64p]
        lib.dl4j_free.argtypes = [ctypes.c_void_p]
        lib.dl4j_cbow_contexts.restype = ctypes.c_int64
        lib.dl4j_cbow_contexts.argtypes = [
            _i32p, _i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
            _i32p, _i32p]
        lib.dl4j_glove_cooc.restype = ctypes.c_int64
        lib.dl4j_glove_cooc.argtypes = [
            _i32p, _i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            ctypes.POINTER(_f32p)]
        lib.dl4j_skipgram_pairs.restype = ctypes.c_int64
        lib.dl4j_skipgram_pairs.argtypes = [
            _i32p, _i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
            _i32p, _i32p]
        _lib = lib
        return _lib


def available():
    return get_lib() is not None


# ---------------------------------------------------------------------------
# High-level wrappers (None on unavailability -> caller falls back)
# ---------------------------------------------------------------------------

def read_idx_u8(path, scale=1.0):
    """Parse a u8 IDX file -> float32 ndarray scaled by `scale`."""
    lib = get_lib()
    if lib is None:
        return None
    ndim = ctypes.c_int32()
    dims = (ctypes.c_int64 * 4)()
    count = ctypes.c_int64()
    ptr = lib.dl4j_read_idx_u8(str(path).encode(), float(scale),
                               ctypes.byref(ndim), dims, ctypes.byref(count))
    if not ptr:
        return None
    shape = tuple(dims[i] for i in range(ndim.value))
    n = int(np.prod(shape))
    if n != count.value:  # C-side validated count must match; never read past it
        lib.dl4j_free(ptr)
        return None
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).reshape(shape).copy()
    lib.dl4j_free(ptr)
    return arr


def parse_csv(path, delimiter=",", skip_lines=0):
    """Parse a numeric CSV -> float32 [rows, cols] ndarray (None for a
    file with non-numeric content, or without the library)."""
    lib = get_lib()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = lib.dl4j_parse_csv(str(path).encode(),
                             ctypes.c_char(delimiter.encode()),
                             int(skip_lines), ctypes.byref(rows),
                             ctypes.byref(cols))
    if not ptr:
        return None
    n = rows.value * cols.value
    if n == 0:            # empty-but-valid file sentinel
        lib.dl4j_free(ptr)
        return np.zeros((0, 0), np.float32)
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).reshape(
        rows.value, cols.value).copy()
    lib.dl4j_free(ptr)
    return arr


def _corpus_args(ids, offsets):
    ids = np.ascontiguousarray(ids, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    return ids, offsets, (ids.ctypes.data_as(_i32p),
                          offsets.ctypes.data_as(_i64p),
                          int(offsets.shape[0]) - 1)


def skipgram_pairs(ids, offsets, window, seed):
    """Corpus-level word2vec reduced-window pair generation in C++.

    ids: int32 concatenated tokens; offsets: int64 [n_seq+1]; returns
    (centers, outs) int32 arrays, or None when the library is missing
    (the caller uses the vectorized numpy path)."""
    lib = get_lib()
    if lib is None:
        return None
    ids, offsets, corpus = _corpus_args(ids, offsets)
    cap = int(ids.shape[0]) * 2 * int(window)
    centers = np.empty(cap, np.int32)
    outs = np.empty(cap, np.int32)
    n = lib.dl4j_skipgram_pairs(
        *corpus, int(window), int(seed) & (2**64 - 1),
        centers.ctypes.data_as(_i32p), outs.ctypes.data_as(_i32p))
    return centers[:n], outs[:n]


def cbow_contexts(ids, offsets, window, seed):
    """Corpus-level CBOW context rows in C++. Returns (context [rows, 2w]
    int32 with -1 padding, targets [rows] int32), or None when the library
    is missing."""
    lib = get_lib()
    if lib is None:
        return None
    ids, offsets, corpus = _corpus_args(ids, offsets)
    cap = int(ids.shape[0])
    context = np.empty((cap, 2 * int(window)), np.int32)
    targets = np.empty(cap, np.int32)
    n = lib.dl4j_cbow_contexts(
        *corpus, int(window), int(seed) & (2**64 - 1),
        context.ctypes.data_as(_i32p), targets.ctypes.data_as(_i32p))
    return context[:n], targets[:n]


def pack_corpus(id_lists):
    """Concatenate per-sequence id lists into (ids int32, offsets int64)
    — the corpus layout every native generator consumes."""
    ids = np.concatenate([np.asarray(s, np.int32) for s in id_lists])
    offsets = np.zeros(len(id_lists) + 1, np.int64)
    np.cumsum([len(s) for s in id_lists], out=offsets[1:])
    return ids, offsets


def glove_cooc(ids, offsets, window, symmetric):
    """Windowed 1/distance co-occurrence counting in C++. Returns (i, j, x)
    COO arrays, or None when the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    ids, offsets, corpus = _corpus_args(ids, offsets)
    pi, pj, px = _i32p(), _i32p(), _f32p()
    n = lib.dl4j_glove_cooc(*corpus, int(window), int(bool(symmetric)),
                            ctypes.byref(pi), ctypes.byref(pj),
                            ctypes.byref(px))
    if n < 0:
        return None
    if n == 0:
        for p in (pi, pj, px):
            lib.dl4j_free(p)
        z = np.zeros(0, np.int32)
        return z, z.copy(), np.zeros(0, np.float32)
    out = tuple(np.ctypeslib.as_array(p, shape=(n,)).copy()
                for p in (pi, pj, px))
    for p in (pi, pj, px):
        lib.dl4j_free(p)
    return out
