"""The port stands alone: `deeplearning4j_tpu_torch`, `chip_smoke.py`,
`chip_bwd_ab.py` and `chip_fwd_ab.py` import neither JAX nor anything of
the JAX package `deeplearning4j_tpu`, and importing the port builds no
kernel and needs no card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deeplearning4j_tpu_torch"

_PROBE = """
import sys
import deeplearning4j_tpu_torch
import deeplearning4j_tpu_torch.models.zoo.transformer
import deeplearning4j_tpu_torch.ops.flash_attention as fa
import deeplearning4j_tpu_torch.parallel.pipeline
import deeplearning4j_tpu_torch.parallel.ring_attention
import deeplearning4j_tpu_torch.nn.multilayer
import deeplearning4j_tpu_torch.nn.graph.computation_graph
import deeplearning4j_tpu_torch.util.model_serializer
import deeplearning4j_tpu_torch.models.zoo.lenet
import deeplearning4j_tpu_torch.models.zoo.resnet
import deeplearning4j_tpu_torch.obs
import deeplearning4j_tpu_torch.obs.decompose
import deeplearning4j_tpu_torch.common.resilience
import deeplearning4j_tpu_torch.common.health
import deeplearning4j_tpu_torch.serving
import deeplearning4j_tpu_torch.serving.server
import deeplearning4j_tpu_torch.serving.metrics
import deeplearning4j_tpu_torch.datasets
import deeplearning4j_tpu_torch.datasets.iterators
import deeplearning4j_tpu_torch.datasets.normalizers
import deeplearning4j_tpu_torch.datasets.mnist
import deeplearning4j_tpu_torch.datasets.fetchers
import deeplearning4j_tpu_torch.datasets.records
import deeplearning4j_tpu_torch.eval
from deeplearning4j_tpu_torch.ops import _build
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
assert not leaked, leaked
# no prefetch thread, server thread or kernel starts at import
import threading
assert threading.active_count() == 1, threading.enumerate()
assert not any(fa.launches.values()) and not fa._fns and not _build._libs
print("ok")
"""


def test_port_imports_without_jax_in_a_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_NAMES = r"(jax|jaxlib|deeplearning4j_tpu)\b(?!_torch)"
_FORBIDDEN = re.compile(
    rf"^\s*(import|from)\s+{_NAMES}|import_module\(\s*['\"]{_NAMES}"
    rf"|__import__\(\s*['\"]{_NAMES}", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "chip_bwd_ab.py", "chip_fwd_ab.py"]))
def test_no_jax_import_in_source(path):
    found = _FORBIDDEN.search((REPO / path).read_text())
    assert found is None, f"{path}: {found and found.group(0)}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from deeplearning4j_tpu.ops import flash_attention",
                 "import deeplearning4j_tpu", "  from jaxlib import y",
                 "importlib.import_module('jax')"):
        assert _FORBIDDEN.search(line), line
    for line in ("from deeplearning4j_tpu_torch.ops import flash_attention",
                 "import deeplearning4j_tpu_torch", "# no jax here",
                 "x = 'deeplearning4j_tpu/ops/flash_attention.py:108'"):
        assert not _FORBIDDEN.search(line), line
