"""The plain reference against the port at toy sizes, on the CPU: the
same first steps and the same served probabilities from the same
inputs."""
import pytest
import torch

from portbench import check, traffic as T
from portbench.loops import evaluate as E, fit as F
from portbench.reference import common as C, steps as RS

from . import checkout, cells


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return checkout.make(tmp_path_factory.mktemp("checkout")) / \
        "BENCHMARK.json"


def _first_steps(s, reference_dtype):
    cfg, tr, fam = s.cell.config, s.cell.traffic, s.cell.family
    net = fam.build(cfg, C.subseed(s.seed, "program"), "cpu")
    host = C.to_host(C.make_params(fam.reference.leaves(cfg), s.seed, "cpu"))
    net.from_jax_params(fam.params_tree(cfg, host))
    data = T.pool(cfg, tr, s.seed, "cpu")
    prog = F.program_first_steps(s, net, net.fit, data, host)
    params = {k: v.to(reference_dtype) for k, v in
              C.make_params(fam.reference.leaves(cfg), s.seed, "cpu").items()}
    batches = [(x.to(reference_dtype), y.to(reference_dtype)) for x, y in
               T.host_images(data, tr, range(tr["check_steps"]), "cpu")]
    ref = RS.train(fam.reference.Model(cfg), params, batches,
                   lr=cfg["learning_rate"], momentum=cfg["momentum"],
                   bn_names=fam.reference.batch_norms(cfg),
                   decay=cfg.get("batch_norm", {}).get("decay", 0.9),
                   gen=torch.Generator().manual_seed(
                       C.subseed(s.seed, "program")))
    return check.train_readings(prog, ref)


def test_resnet_first_steps_in_float64(bench):
    # in float64 the port's and the reference's arithmetic agree to
    # rounding; in float32 BatchNorm's gradients at He init are too
    # ill-conditioned at toy sizes for a tight comparison
    s = cells.session(bench, "resnet50-toy.toy.train-b16", 11)
    s.cell.config["data_type"] = "float64"
    r = _first_steps(s, torch.float64)
    assert r["loss_gap"] < 1e-10
    assert r["grad_gap"] < 1e-10
    # the running variance: the port's one-pass E[x^2] - E[x]^2 against
    # the reference's two-pass variance
    assert r["change_gap"] < 1e-5


def test_vgg_first_steps_with_the_same_dropout_masks(bench):
    s = cells.session(bench, "vgg16-toy.toy.train-b16", 12)
    r = _first_steps(s, torch.float32)
    assert r["loss_gap"] < 1e-5
    assert r["grad_gap"] < 1e-3
    assert r["change_gap"] < 1e-3


def test_served_probabilities(bench):
    s = cells.session(bench, "resnet50-toy.toy.eval-b16", 13)
    m = E.run(s)
    assert m["readings"]["prob_gap"] < 1e-5
    assert m["attempted"] >= 1 and m["failed"] == 0
