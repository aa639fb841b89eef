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
beside `resolve_device`, and every subpackage whose reference
`__init__.py` has an `__all__` the reference's names, in its order where
the port adds none of its own; `ops` is the one kept apart on purpose
(`ops.flash_attention` stays the module). Every `.py` file of the
reference has a port file at the same path, except `common/jax_compat.py`
(a JAX version shim), and holds the reference file's module-level public
names, but for a commented list of JAX-only names, loggers and helpers the
reference only imports."""
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


def _packages_with_all():
    """Every subpackage of the reference whose `__init__.py` has an
    `__all__` (the package itself has its own test above)."""
    root = REPO / "deeplearning4j_tpu"
    return sorted(p.parent.relative_to(root).as_posix()
                  for p in root.rglob("__init__.py")
                  if p.parent != root and "__pycache__" not in p.parts
                  and re.search(r"__all__ = \[", p.read_text()))


# what a port package exports beside the reference's names: the port's own
# helpers, the models the port adds to the zoo, and modules of the parallel
# and serving layers that its callers reach through the package
_PORT_EXTRAS = {
    "common": {"card_numerics", "resolve_device", "to_port", "to_public"},
    "models": {"TransformerLM", "lenet", "resnet50"},
    "models/zoo": {"TransformerLM", "init_lm"},
    "parallel": {"mesh_cost", "moe", "early_stopping",
                 "blockwise_attention", "ring_self_attention"},
    "serving": {"HEALTHY", "DEGRADED", "DRAINING", "DEAD", "BREAKER_CLOSED",
                "BREAKER_OPEN", "BREAKER_HALF_OPEN"},
}


@pytest.mark.parametrize("package", [
    p for p in _packages_with_all()
    # kept on purpose: the reference exports the function flash_attention,
    # which shadows its module (test_ops_flash_attention_stays_the_module)
    if p != "ops"])
def test_subpackages_export_the_reference_s_names(package):
    """Every reference `__init__.py` with an `__all__`: the port's exports
    the same names in the same order, or, where the port adds its own
    (`_PORT_EXTRAS`), the reference's names and those; each resolves."""
    import importlib
    mod = importlib.import_module(
        "deeplearning4j_tpu_torch." + package.replace("/", "."))
    names = _reference_all(f"{package}/__init__.py")
    extras = _PORT_EXTRAS.get(package)
    if extras is None:
        assert mod.__all__ == names
    else:
        assert len(mod.__all__) == len(set(mod.__all__))
        assert set(mod.__all__) == set(names) | extras
    assert all(hasattr(mod, n) for n in mod.__all__)


def test_ops_flash_attention_stays_the_module():
    """Kept on purpose (ROADMAP.md, "Differences kept on purpose"): the
    reference's `ops/__init__.py` exports the function `flash_attention`,
    which shadows its module; the port's exports nothing, and
    `ops.flash_attention` is the module that holds the kernels' wrappers,
    plain versions and launch counters, as the port, its tests and the
    chip scripts import it."""
    import types

    import deeplearning4j_tpu_torch.ops as ops
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    assert _reference_all("ops/__init__.py") == ["flash_attention"]
    assert getattr(ops, "__all__", []) == []
    assert isinstance(fa, types.ModuleType)
    assert ops.flash_attention is fa
    assert callable(fa.flash_attention) and isinstance(fa.launches, dict)


def _public_names(path):
    """A module's module-level public names, read from its source: what it
    defines or assigns (under `if` and `try` too) and what it imports from
    its own package (relative imports); not the modules and names it
    imports from the standard library or a third party."""
    import ast
    names = set()

    def visit(nodes):
        for n in nodes:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign)):
                for t in (n.targets if isinstance(n, ast.Assign)
                          else [n.target]):
                    names.update(x.id for x in ast.walk(t)
                                 if isinstance(x, ast.Name))
            elif isinstance(n, ast.ImportFrom) and n.level > 0:
                names.update(a.asname or a.name for a in n.names)
            elif isinstance(n, ast.If):
                visit(n.body + n.orelse)
            elif isinstance(n, ast.Try):
                visit(n.body + n.orelse + n.finalbody
                      + [s for h in n.handlers for s in h.body])

    visit(ast.parse(path.read_text()).body)
    return {n for n in names if not n.startswith("_")}


# a reference file's module-level public names that its port file does not
# have, on purpose, by reason
_LEFT_OUT = {
    # JAX-only: the scan loops of jitted steps, the batch's
    # PartitionSpec, the JAX version shim's shard_map, jit's cache size,
    # Pallas' masked-score constant and TPU module (ROADMAP.md queue 1's
    # note)
    "nn/fused.py": {"scan_steps", "scan_batches"},
    "parallel/sharding.py": {"batch_spec"},
    "parallel/moe.py": {"shard_map"},
    "parallel/pipeline.py": {"shard_map"},
    "models/zoo/transformer.py": {"GEN_JIT_CACHE_SIZE"},
    "ops/flash_attention.py": {"NEG_INF", "pltpu"},
    # kept on purpose: the package exports nothing, and
    # ops.flash_attention is the module
    "ops/__init__.py": {"flash_attention"},
    # loggers: the port's module logs nothing, or not through this name
    "nn/multilayer.py": {"log"},
    "parallel/parallel_wrapper.py": {"log"},
    "parallel/training_master.py": {"log"},
    # ... and helpers the reference's module imports for its own body,
    # which no caller reaches through it: the layer base class, the
    # updaters, the iterator helper and the tracer in the graph; the zoo's
    # dropout layer; the parameter server's batch helper in the hook
    "nn/graph/computation_graph.py": {"log", "LayerConf", "U",
                                      "next_processed", "obs"},
    "models/zoo/classic_cnns.py": {"DropoutLayer"},
    "parallel/training_hook.py": {"ps_batch"},
}


def _shared_files():
    root = REPO / "deeplearning4j_tpu"
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts
                  and (PORT / p.relative_to(root)).exists())


def test_left_out_names_are_each_the_reference_s():
    """Each name `_LEFT_OUT` excuses is one of the reference file's and not
    one of the port file's: the list holds nothing stale."""
    for rel, left in _LEFT_OUT.items():
        ref = _public_names(REPO / "deeplearning4j_tpu" / rel)
        port = _public_names(PORT / rel)
        assert left <= ref - port, (rel, left - (ref - port))


@pytest.mark.parametrize("rel", _shared_files())
def test_port_files_hold_the_reference_s_public_names(rel):
    """Every module-level public name of a reference file is in the port
    file at the same path, but for the names `_LEFT_OUT` lists."""
    missing = (_public_names(REPO / "deeplearning4j_tpu" / rel)
               - _public_names(PORT / rel) - _LEFT_OUT.get(rel, set()))
    assert not missing, f"{rel}: {sorted(missing)}"


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
