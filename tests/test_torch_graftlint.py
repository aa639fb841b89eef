"""graftlint over the port: tools/analyze/layers_torch.toml (the
reference's layer rules and pass scopes rooted at deeplearning4j_tpu_torch,
with `torch` denied to the stdlib-only layers) reports zero active
findings with no baseline; every inline suppression in the port stands
where the reference has the same one; and the rules catch the imports
they exist to refuse."""
import os

import pytest

from tools.analyze import layering
from tools.analyze.core import SourceFile, load_config, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "tools", "analyze", "layers_torch.toml")


@pytest.fixture(scope="module")
def port_report():
    return run(config=load_config(path=CONFIG), baseline={})


def test_port_has_zero_active_findings(port_report):
    d = port_report.as_dict()
    assert d["files_checked"] > 50
    assert d["active"] == [], d["active"]


def _site(f, package):
    """(module path inside its package, finding key): where a finding
    stands, independent of which package holds the file."""
    return (f.path[len(package) + 1:], f.key)


def test_every_suppression_mirrors_the_reference(port_report):
    ref = run(config=load_config(), baseline={})
    ref_sites = {_site(f, "deeplearning4j_tpu") for f in ref.suppressed}
    port_sites = {_site(f, "deeplearning4j_tpu_torch")
                  for f in port_report.suppressed}
    assert port_sites, "the copied wire's suppressions were not seen"
    assert port_sites <= ref_sites, sorted(port_sites - ref_sites)


@pytest.mark.parametrize("relpath, source, rule", [
    ("obs/fleet.py", "import torch\n", "obs-stdlib-only"),
    ("obs/registry.py", "import numpy as np\n", "obs-stdlib-only"),
    ("serving/fleetjournal.py", "import torch\n",
     "serving-host-halves-stdlib-only"),
    ("serving/metrics.py", "from torch import nn\n",
     "serving-host-halves-stdlib-only"),
    ("obs/trace.py", "from ..serving import decode\n",
     "obs-below-serving"),
    ("serving/fleet.py", "from ..parallel import ps_transport\n",
     "serving-no-parallel-internals"),
    ("serving/wire.py", "import jax\n",
     "port-never-imports-the-reference"),
    ("models/zoo/transformer.py",
     "from deeplearning4j_tpu.models.zoo import transformer\n",
     "port-never-imports-the-reference"),
])
def test_rules_refuse_what_they_exist_to_refuse(relpath, source, rule):
    cfg = load_config(path=CONFIG)
    path = f"deeplearning4j_tpu_torch/{relpath}"
    found = layering.check(cfg, [SourceFile(path, source, root=REPO)])
    assert any(f.key.startswith(f"layer:{rule}:") for f in found), found


def test_sanctioned_seams_pass():
    cfg = load_config(path=CONFIG)
    ok = [("serving/wire.py",
           "from ..parallel.ps_transport import pack_leaves\n"),
          ("serving/loadgen.py", "import numpy as np\n"),
          ("serving/fleet.py", "import torch\n"),
          ("serving/decode.py", "import deeplearning4j_tpu_torch.obs\n")]
    for relpath, source in ok:
        path = f"deeplearning4j_tpu_torch/{relpath}"
        assert layering.check(
            cfg, [SourceFile(path, source, root=REPO)]) == [], relpath
