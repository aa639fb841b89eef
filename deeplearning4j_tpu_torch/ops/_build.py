"""Builds the port's CUDA sources (`csrc/*.cu`) and loads them with ctypes.

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
with a plain C interface, at first use, into `build/kernels/` at the root of
the checkout (listed in .gitignore). The library's name carries a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
or header is rebuilt. Nothing is built when a
module is imported, and only sources in the repository are built. A build
failure raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output (with ptxas' register and spill report) for `name`."""
    return library_path(name).with_suffix(".log")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names=None) -> dict[str, Path]:
    """Compile each named source (default: all) whose library is missing.

    One nvcc per source, all started together. Returns {name: library path};
    raises RuntimeError naming every source that failed."""
    names = sources() if names is None else list(names)
    todo = [name for name in names if not library_path(name).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(log_path(name), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
        running.append((name, proc, log, tmp, out))
    failed = []
    for name, proc, log, tmp, out in running:
        proc.wait()
        log.close()
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{log_path(name).read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
