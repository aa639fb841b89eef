"""The port stands alone: `deeplearning4j_tpu_torch`, `chip_smoke.py`,
`chip_bwd_ab.py`, `chip_fwd_ab.py`, `chip_recurrent.py`,
`chip_embeddings.py`, `chip_parallel.py`, `chip_fused.py`,
`chip_spec_kv.py`, `chip_fleet.py`, `chip_tools.py`, `chip_pretrain.py`,
`chip_model_parallel.py`, `chip_ui.py` and `chip_graph_stream.py` import
neither JAX, nor `ml_dtypes` (the card's machine has neither), nor
anything of the JAX package `deeplearning4j_tpu`, and
importing the
port (its `models` package with the embeddings included, and the whole
`parallel` package) builds no kernel, builds or loads no native library,
starts no thread, opens no process group and needs no card; the Keras
import (`keras/`, in the scan) does not import h5py either. The fleet
plane's stdlib halves (`obs/*.py`, `serving/fleetjournal.py`) import
neither torch nor numpy themselves, as the reference's layering rules
demand of theirs (tools/analyze/layers_torch.toml holds the same). The names
the port does not have yet raise NotImplementedError naming their
ROADMAP.md queue 1 item. The package exports the reference's six names
beside `resolve_device`, and `text`, `graph`, `streaming` and `cloud` the
reference's `__all__`, in its order. Every `.py` file of the reference has
a port file at the same path, except `common/jax_compat.py` (a JAX version
shim)."""
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
import deeplearning4j_tpu_torch.parallel
import deeplearning4j_tpu_torch.parallel.sharding
import deeplearning4j_tpu_torch.parallel.parallel_wrapper
import deeplearning4j_tpu_torch.parallel.distributed
import deeplearning4j_tpu_torch.parallel.magic_queue
import deeplearning4j_tpu_torch.parallel.parameter_server
import deeplearning4j_tpu_torch.parallel.ps_transport
import deeplearning4j_tpu_torch.parallel.training_hook
import deeplearning4j_tpu_torch.parallel.training_master
import deeplearning4j_tpu_torch.parallel.time_source
import deeplearning4j_tpu_torch.util.sharded_checkpoint
import deeplearning4j_tpu_torch.nn.multilayer
import deeplearning4j_tpu_torch.nn.graph.computation_graph
import deeplearning4j_tpu_torch.util.model_serializer
import deeplearning4j_tpu_torch.models.zoo.lenet
import deeplearning4j_tpu_torch.models.zoo.resnet
import deeplearning4j_tpu_torch.models.zoo.char_rnn
import deeplearning4j_tpu_torch.nn.conf.layers.recurrent
import deeplearning4j_tpu_torch.nn.conf.layers.attention
import deeplearning4j_tpu_torch.obs
import deeplearning4j_tpu_torch.obs.decompose
import deeplearning4j_tpu_torch.common.resilience
import deeplearning4j_tpu_torch.common.health
import deeplearning4j_tpu_torch.serving
import deeplearning4j_tpu_torch.serving.server
import deeplearning4j_tpu_torch.serving.metrics
import deeplearning4j_tpu_torch.serving.decode
import deeplearning4j_tpu_torch.serving.kvpool
import deeplearning4j_tpu_torch.serving.admission
import deeplearning4j_tpu_torch.serving.kvstate
import deeplearning4j_tpu_torch.serving.speculate
import deeplearning4j_tpu_torch.serving.loadgen
import deeplearning4j_tpu_torch.serving.fleet
import deeplearning4j_tpu_torch.serving.fleetjournal
import deeplearning4j_tpu_torch.serving.wire
import deeplearning4j_tpu_torch.obs.fleet
import deeplearning4j_tpu_torch.datasets
import deeplearning4j_tpu_torch.datasets.iterators
import deeplearning4j_tpu_torch.datasets.normalizers
import deeplearning4j_tpu_torch.datasets.mnist
import deeplearning4j_tpu_torch.datasets.fetchers
import deeplearning4j_tpu_torch.datasets.records
import deeplearning4j_tpu_torch.eval
import deeplearning4j_tpu_torch.models
import deeplearning4j_tpu_torch.models.embeddings
import deeplearning4j_tpu_torch.models.embeddings.learning
import deeplearning4j_tpu_torch.models.embeddings.serializer
import deeplearning4j_tpu_torch.models.word2vec.static_word2vec
import deeplearning4j_tpu_torch.models.word2vec.word2vec
import deeplearning4j_tpu_torch.models.sequencevectors
import deeplearning4j_tpu_torch.models.paragraphvectors
import deeplearning4j_tpu_torch.models.glove
import deeplearning4j_tpu_torch.text
import deeplearning4j_tpu_torch.text.treeparser
import deeplearning4j_tpu_torch.text.ja_lattice
import deeplearning4j_tpu_torch.text.ja_dictionary
import deeplearning4j_tpu_torch.text.ko_morph
import deeplearning4j_tpu_torch.graph
import deeplearning4j_tpu_torch.streaming
import deeplearning4j_tpu_torch.cloud
import deeplearning4j_tpu_torch.optimize
import deeplearning4j_tpu_torch.optimize.listeners
import deeplearning4j_tpu_torch.optimize.solvers
import deeplearning4j_tpu_torch.optimize.profiler
import deeplearning4j_tpu_torch.earlystopping
import deeplearning4j_tpu_torch.gradientcheck
import deeplearning4j_tpu_torch.parallel.early_stopping
import deeplearning4j_tpu_torch.models.zoo.classic_cnns
import deeplearning4j_tpu_torch.graft_entry
import deeplearning4j_tpu_torch.nn.conf.layers.rbm
import deeplearning4j_tpu_torch.nn.conf.layers.variational
import deeplearning4j_tpu_torch.keras
import deeplearning4j_tpu_torch.keras.keras_import
import deeplearning4j_tpu_torch.keras.server
from deeplearning4j_tpu_torch.common import native_ops
from deeplearning4j_tpu_torch.ops import _build
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                       "deeplearning4j_tpu", "h5py"))
assert not leaked, leaked
# no prefetch thread, server thread or kernel starts at import
import threading
assert threading.active_count() == 1, threading.enumerate()
assert not any(fa.launches.values()) and not fa._fns and not _build._libs
# nor is the native library built or loaded, and CUDA is not initialised
assert native_ops._lib is None and not native_ops._build_attempted
import torch
assert not torch.cuda.is_initialized()
import torch.distributed as dist
assert not dist.is_initialized()
print("ok")
"""


def test_port_imports_without_jax_in_a_fresh_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_NAMES = r"(jax|jaxlib|ml_dtypes|deeplearning4j_tpu)\b(?!_torch)"
_FORBIDDEN = re.compile(
    rf"^\s*(import|from)\s+{_NAMES}|import_module\(\s*['\"]{_NAMES}"
    rf"|__import__\(\s*['\"]{_NAMES}", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "chip_bwd_ab.py", "chip_fwd_ab.py",
       "chip_recurrent.py", "chip_embeddings.py", "chip_parallel.py",
       "chip_fused.py", "chip_spec_kv.py", "chip_fleet.py",
       "chip_tools.py", "chip_pretrain.py", "chip_model_parallel.py",
       "chip_ui.py", "chip_graph_stream.py"]))
def test_no_jax_import_in_source(path):
    found = _FORBIDDEN.search((REPO / path).read_text())
    assert found is None, f"{path}: {found and found.group(0)}"


_HEAVY = re.compile(r"^\s*(import|from)\s+(torch|numpy)\b", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in (PORT / "obs").glob("*.py")]
    + ["deeplearning4j_tpu_torch/serving/fleetjournal.py"]))
def test_fleet_plane_stdlib_halves_name_neither_torch_nor_numpy(path):
    found = _HEAVY.search((REPO / path).read_text())
    assert found is None, f"{path}: {found and found.group(0)}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from deeplearning4j_tpu.ops import flash_attention",
                 "import deeplearning4j_tpu", "  from jaxlib import y",
                 "importlib.import_module('jax')", "import ml_dtypes",
                 "from ml_dtypes import bfloat16"):
        assert _FORBIDDEN.search(line), line
    for line in ("from deeplearning4j_tpu_torch.ops import flash_attention",
                 "import deeplearning4j_tpu_torch", "# no jax here",
                 "x = 'deeplearning4j_tpu/ops/flash_attention.py:108'"):
        assert not _FORBIDDEN.search(line), line


@pytest.mark.parametrize("name,item", [
    ("PipelineParallel", 20), ("moe_mlp_sharded", 20),
    ("zero_state_sharding", 20), ("main", 22)])
def test_unported_parallel_names_raise_with_their_items(name, item):
    """Item 20's names resolve to the ported modules' (model parallelism);
    item 22's `main` is the command line's module, importable, and nothing
    in the package raises naming an item any more."""
    import deeplearning4j_tpu_torch.parallel as P
    from deeplearning4j_tpu_torch.parallel import moe, pipeline, sharding
    if item == 22:
        import importlib
        main = importlib.import_module("deeplearning4j_tpu_torch.parallel.main")
        assert callable(main.run) and callable(main.build_parser)
        assert not hasattr(P, "_NOT_PORTED")
        assert not hasattr(sharding, "not_ported")
    else:
        home = {"PipelineParallel": pipeline, "moe_mlp_sharded": moe,
                "zero_state_sharding": sharding}[name]
        assert getattr(P, name) is getattr(home, name)
        assert name in P.__all__
    with pytest.raises(AttributeError):
        P.no_such_name


def test_early_stopping_names_resolve_in_parallel():
    import deeplearning4j_tpu_torch.parallel as P
    from deeplearning4j_tpu_torch.parallel import (
        EarlyStoppingParallelTrainer, MasterDataSetLossCalculator,
        SparkEarlyStoppingTrainer, TpuEarlyStoppingTrainer, early_stopping)
    assert SparkEarlyStoppingTrainer is TpuEarlyStoppingTrainer
    assert early_stopping.EarlyStoppingParallelTrainer is \
        EarlyStoppingParallelTrainer
    assert issubclass(MasterDataSetLossCalculator,
                      early_stopping.DataSetLossCalculator)
    for name in ("EarlyStoppingParallelTrainer", "MasterDataSetLossCalculator",
                 "SparkEarlyStoppingTrainer", "TpuEarlyStoppingTrainer",
                 "early_stopping"):
        assert name in P.__all__


def test_package_exports_the_reference_s_names():
    import deeplearning4j_tpu_torch as D
    from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration \
        import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        MultiLayerConfiguration, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    # the reference's __init__.py:18-33, and resolve_device
    assert sorted(D.__all__) == sorted([
        "ComputationGraph", "ComputationGraphConfiguration", "InputType",
        "MultiLayerConfiguration", "NeuralNetConfiguration",
        "MultiLayerNetwork", "resolve_device"])
    assert (D.ComputationGraph, D.ComputationGraphConfiguration, D.InputType,
            D.MultiLayerConfiguration, D.NeuralNetConfiguration,
            D.MultiLayerNetwork) == (
        ComputationGraph, ComputationGraphConfiguration, InputType,
        MultiLayerConfiguration, NeuralNetConfiguration, MultiLayerNetwork)
    reference = (REPO / "deeplearning4j_tpu" / "__init__.py").read_text()
    names = re.search(r"__all__ = \[(.*?)\]", reference, re.S).group(1)
    assert sorted(re.findall(r'"(\w+)"', names)) == sorted(
        n for n in D.__all__ if n != "resolve_device")


def _reference_all(rel):
    """The names of the reference's `__all__` in `rel`, in order, read
    from its source (importing it would import JAX)."""
    text = (REPO / "deeplearning4j_tpu" / rel).read_text()
    return re.findall(r'"(\w+)"', re.search(r"__all__ = \[(.*?)\]", text,
                                            re.S).group(1))


@pytest.mark.parametrize("package", ["text", "graph", "streaming", "cloud"])
def test_subpackages_export_the_reference_s_names(package):
    import importlib
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.{package}")
    names = _reference_all(f"{package}/__init__.py")
    assert mod.__all__ == names
    assert all(hasattr(mod, n) for n in names)


def test_every_reference_file_has_a_port_file():
    """Both packages' `.py` files, by relative path: the one reference file
    without a port file is the JAX version shim."""
    def files(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if "__pycache__" not in p.parts}
    missing = files(REPO / "deeplearning4j_tpu") - files(PORT)
    assert missing == {"common/jax_compat.py"}


def test_unported_training_options_raise_with_their_items():
    from deeplearning4j_tpu_torch.models.zoo.lenet import lenet
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, ParameterAveragingTrainingMaster)
    net = lenet(device="cpu")
    # item 16 is ported: set_listeners returns the net
    assert net.set_listeners() is net and net.listeners == []
    # item 18b is ported: pretrain_layer refuses a layer that cannot
    # pretrain, pretrain visits none of LeNet's
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrain_layer(0, None)
    assert net.pretrain(None) is net
    # item 22 is ported: collect_activation_stats arms and disarms
    assert net.collect_activation_stats(True, 4, 16)._act_stats_cfg == \
        (4, 16)
    assert net.collect_activation_stats(False)._act_stats_cfg is None
    # items 17 and 20a are ported: the options build
    b = ParallelWrapper.Builder(net).health_policy(True).checkpointing("d")
    assert b._health_policy is True and b._checkpoint["directory"] == "d"
    tm = ParameterAveragingTrainingMaster.Builder().health_policy(True)
    assert tm._health_policy is True
    assert net.fused_steps(4)._fused_steps == 4
