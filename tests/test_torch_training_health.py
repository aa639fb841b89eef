"""The port's training-health watchdog (`common/health.py`, the armed step of
`nn/multilayer.py`, `ParallelWrapper`'s and the TrainingMaster's round
seams) against the JAX package's.

In the pytest process:
- the policy (copied from the reference) fed the same health sequences as
  the JAX policy: the same actions, counts and event rounds;
- a NaN batch skipped on the device: the parameters after it bit-identical
  to those before, the counters advanced, the score kept;
- the fit loop's rollback through the checkpoint seam (the reference's
  tests/test_training_health.py:215-236), the port against the JAX package
  from the same numpy weights and batches, float64, within 1e-5: the same
  counts, restored round and iteration_count;
- the abort names the offending rounds;
- the iterator validator's raise / skip / count policies through the
  copied policy.

On 2 gloo CPU ranks (one module fixture starts 2 processes running this
file as a script, joined through a FileStore under the tmp dir; 120 s to
finish): `ParallelWrapper.workers(2)` held to the contract of the
reference's :238-266 (rollback: restored round 5, iteration_count 7, bit-
equal to the run that never saw the poisoned batch), :269-288 (a NaN round
skipped, parameters unchanged), :291-303 (consecutive NaN rounds abort
naming rounds [3, 4]) and :306-317 (a rollback without checkpoints is
counted); and the TrainingMaster's k-step round (:336-367): a NaN global
batch is one skipped local step a rank, a partial round ("2/4 local steps")
that does not escalate, and a divergence rolls back through the master's
round checkpoints to round 3, bit-equal to the master run that stops
there. The reference's own :308 (`test_wrapper_rollback_completes_and_is_
bit_comparable`) and :401 fail today (its restored run differs from the
run without the batch by 7.5e-9 after XLA re-places the restored arrays);
the port is held to the contract those tests state.
"""
import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.common.health import (TrainingDivergedError,
                                                    TrainingHealthPolicy)
from deeplearning4j_tpu_torch.common.resilience import FaultInjector
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator, BatchValidationError, DataSetValidator,
    ListDataSetIterator, ValidatingDataSetIterator)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, ParameterAveragingTrainingMaster)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 120


def _net(seed=7, data_type="float32"):
    conf = (NeuralNetConfiguration.Builder().seed(seed).data_type(data_type)
            .updater("adam").learning_rate(0.01).list()
            .layer(0, DenseLayer(n_out=8, activation="relu"))
            .layer(1, OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _reg_net(seed=7, data_type="float32"):
    """MSE head: a value-poisoned batch explodes the gradient norm."""
    conf = (NeuralNetConfiguration.Builder().seed(seed).data_type(data_type)
            .updater("adam").learning_rate(0.01).list()
            .layer(0, DenseLayer(n_out=8, activation="identity"))
            .layer(1, OutputLayer(n_out=3, activation="identity",
                                  loss_function="mse"))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=128, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, 5)).astype(np.float32)
    w = r.random((5, 3))
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return DataSet(x, y)


def _nan_batch(n=16):
    return DataSet(np.full((n, 5), np.nan, np.float32),
                   np.eye(3, dtype=np.float32)[np.zeros(n, int)])


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import types

    from deeplearning4j_tpu import (InputType as JInputType,
                                    MultiLayerNetwork as JNet,
                                    NeuralNetConfiguration as JConf)
    from deeplearning4j_tpu.common import health as JH
    from deeplearning4j_tpu.common.resilience import \
        FaultInjector as JInjector
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.datasets.iterators import (
        DataSetValidator as JValidator, ListDataSetIterator as JList,
        ValidatingDataSetIterator as JValidating)
    from deeplearning4j_tpu.nn.conf import layers as JL
    return types.SimpleNamespace(
        jax=jax, H=JH, Injector=JInjector, DataSet=JDataSet, List=JList,
        Validator=JValidator, Validating=JValidating, Net=JNet, Conf=JConf,
        InputType=JInputType, L=JL)


# ------------------------------------------------------------------ policy

def _h(score, grad_norm=1.0, finite=True, **extra):
    return dict({"score": score, "grad_norm": grad_norm,
                 "all_finite": finite}, **extra)


SEQUENCES = {
    "ema_spike": (dict(spike_zscore=4.0, ema_decay=0.5, warmup_steps=5,
                       max_consecutive_bad=10),
                  [_h(1.0 + 0.01 * (i % 3)) for i in range(8)]
                  + [_h(100.0), _h(1.0), _h(1.02)]),
    "grad_norm_no_rollback": (dict(grad_norm_limit=10.0,
                                   rollback_on_spike=False,
                                   max_consecutive_bad=10),
                              [_h(1.0), _h(1.0, grad_norm=50.0), _h(1.1)]),
    "grad_norm_rollback": (dict(grad_norm_limit=10.0),
                           [_h(1.0, grad_norm=50.0), _h(0.9)]),
    "abort": (dict(max_consecutive_bad=3),
              [_h(1.0), _h(np.nan, finite=False),
               _h(np.nan, finite=False), _h(np.nan, finite=False)]),
    "partial_round": (dict(max_consecutive_bad=2),
                      [_h(0.5, grad_norm=np.nan, finite=False, bad_steps=2,
                          steps=4),
                       _h(0.4, grad_norm=np.nan, finite=False, bad_steps=1,
                          steps=4),
                       _h(0.3)]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_policy_classifies_as_the_reference(J, name):
    kw, seq = SEQUENCES[name]
    mine, ref = TrainingHealthPolicy(**kw), J.H.TrainingHealthPolicy(**kw)
    acts = [(mine.observe(h, i), ref.observe(h, i))
            for i, h in enumerate(seq)]
    assert [a for a, _ in acts] == [b for _, b in acts]
    assert mine.counts == ref.counts
    assert mine.consecutive_bad == ref.consecutive_bad
    assert ([(e["kind"], e["round"]) for e in mine.events]
            == [(e["kind"], e["round"]) for e in ref.events])
    assert [e.get("reason") for e in mine.events] == \
        [e.get("reason") for e in ref.events]
    assert mine.diagnose() == ref.diagnose()
    assert mine.snapshot()["counts"] == ref.snapshot()["counts"]


def test_apply_policy_degrades_and_counts_on_the_registry():
    from deeplearning4j_tpu_torch.common import health as H
    from deeplearning4j_tpu_torch.obs.registry import default_registry
    before = default_registry().counter("train.health.spikes").value
    pol = TrainingHealthPolicy(grad_norm_limit=10.0)
    assert H.apply_policy(pol, _h(1.0, grad_norm=50.0), 3) == "spike"
    assert H.apply_policy(pol, _h(1.0, grad_norm=50.0), 4,
                          rollback=lambda: 2) == "rollback"
    assert pol.events[-1] == {"kind": "rollback", "round": 4,
                              "restoredRound": 2}
    assert default_registry().counter("train.health.spikes").value \
        == before + 2


# ------------------------------------------------------------ the fit loop

def test_nan_batch_skipped_params_bit_identical():
    pol = TrainingHealthPolicy(max_consecutive_bad=5)
    net = _net(seed=11).training_health(pol)
    batches = list(_data(48, seed=1).batch_by(16))
    for b in batches[:2]:
        net.fit(b)
    before, score = net.params(), float(net.score())
    net.fit(_nan_batch())
    np.testing.assert_array_equal(net.params(), before)
    assert float(net.score()) == score          # NaN never became it
    assert net.conf.iteration_count == 3        # the skip took a round
    net.fit(batches[2])
    assert not np.array_equal(net.params(), before)
    assert pol.counts == {"ok": 3, "skips": 1, "spikes": 0, "rollbacks": 0,
                          "aborts": 0, "validation_rejects": 0}


def test_disarmed_step_is_the_plain_step():
    batches = list(_data(64, seed=2).batch_by(16))
    a, b = _net(seed=3), _net(seed=3).training_health(True)
    b.training_health(None)
    for n in (a, b):
        n.fit(ListDataSetIterator(batches))
    np.testing.assert_array_equal(a.params(), b.params())
    assert b._health_policy is None and b._health_gen == 2


def test_fit_loop_rollback_matches_the_reference(J, tmp_path):
    """The reference's fit-loop rollback (8 batches, the 5th value-poisoned,
    checkpoints every 2 steps) on both packages from the same weights."""
    conf = (J.Conf.Builder().seed(4).data_type("float64").updater("adam")
            .learning_rate(0.01).list()
            .layer(0, J.L.DenseLayer(n_out=8, activation="identity"))
            .layer(1, J.L.OutputLayer(n_out=3, activation="identity",
                                      loss_function="mse"))
            .set_input_type(J.InputType.feed_forward(5)).build())
    jnet = J.Net(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    tree = lambda t: J.jax.tree.map(np.array, t)  # noqa: E731
    net.from_jax_params(tree(jnet._params), tree(jnet._model_state),
                        tree(jnet._updater_state))
    batches = list(_data(128, seed=3).batch_by(16))

    def poisoned(inj, validator, validating, listing, dataset):
        inj.plan("data.batch", on_call=4, corrupt=500.0)
        v = validator(policy="count", check_finite=False, fault_injector=inj)
        return validating(listing([dataset(b.features, b.labels)
                                   for b in batches]), v)

    runs = {"ref": J.H.TrainingHealthPolicy(grad_norm_limit=50.0,
                                            max_consecutive_bad=4),
            "port": TrainingHealthPolicy(grad_norm_limit=50.0,
                                         max_consecutive_bad=4)}
    jnet.training_health(runs["ref"], checkpoint_dir=tmp_path / "ref",
                         checkpoint_every=2)
    jnet.fit(poisoned(J.Injector(seed=0), J.Validator, J.Validating, J.List,
                      J.DataSet))
    net.training_health(runs["port"], checkpoint_dir=tmp_path / "port",
                        checkpoint_every=2)
    net.fit(poisoned(FaultInjector(seed=0), DataSetValidator,
                     ValidatingDataSetIterator, ListDataSetIterator, DataSet))
    assert runs["port"].counts == runs["ref"].counts
    assert runs["port"].counts["rollbacks"] == 1
    rb = lambda p: [e for e in p.events if e["kind"] == "rollback"]  # noqa
    assert rb(runs["port"])[0]["restoredRound"] == \
        rb(runs["ref"])[0]["restoredRound"] == 4
    assert net.conf.iteration_count == jnet.conf.iteration_count == 7
    np.testing.assert_allclose(net.params(), np.asarray(jnet.params()),
                               rtol=0, atol=1e-5)


def test_fit_loop_abort_names_offending_rounds():
    pol = TrainingHealthPolicy(max_consecutive_bad=2)
    net = _net(seed=6).training_health(pol)
    net.fit(_data(32, seed=6))
    bad = ListDataSetIterator([_nan_batch(), _nan_batch(), _nan_batch()])
    with pytest.raises(TrainingDivergedError,
                       match=r"offending rounds \[1, 2\]"):
        net.fit(bad)
    assert pol.counts["aborts"] == 1


# --------------------------------------------------------------- validator

def test_validator_policies_through_the_copied_policy():
    good, bad = _data(16, seed=0), _nan_batch()
    with pytest.raises(BatchValidationError, match="non-finite"):
        DataSetValidator(policy="raise").validate(bad)
    pol = TrainingHealthPolicy()
    v = DataSetValidator(policy="skip", health_policy=pol)
    assert v.validate(bad) is None
    assert v.validate(good) is good
    assert (v.rejected, v.passed) == (1, 1)
    assert pol.counts["validation_rejects"] == 1
    assert pol.events[-1]["kind"] == "validation_reject"
    v2 = DataSetValidator(policy="count")
    assert v2.validate(bad) is bad
    assert v2.rejected == 1


def test_validator_skip_through_async_staging():
    inj = FaultInjector(seed=0)
    inj.plan("data.batch", on_call=3, corrupt="nan")
    pol = TrainingHealthPolicy()
    v = DataSetValidator(policy="skip", fault_injector=inj,
                         health_policy=pol)
    batches = list(_data(96, seed=1).batch_by(16))
    it = AsyncDataSetIterator(ListDataSetIterator(batches), validator=v,
                              device_put=False)
    seen = []
    while it.has_next():
        seen.append(it.next_batch())
    assert len(seen) == 5
    assert pol.counts["validation_rejects"] == 1


# ----------------------------------------------------------- 2 gloo ranks

def _wrapper(net, ckpt=None, inj=None, pol=None, k=1):
    b = ParallelWrapper.Builder(net).workers(WORLD).averaging_frequency(k)
    if ckpt is not None:
        b = b.checkpointing(str(ckpt))
    if inj is not None:
        b = b.fault_injector(inj)
    if pol is not None:
        b = b.health_policy(pol)
    return b.build()


def _events(pol):
    return [{k: v for k, v in e.items()} for e in pol.events]


def _wrapper_rollback(tmp):
    batches = list(_data(128, seed=5).batch_by(16))
    inj = FaultInjector(seed=0)
    inj.plan("wrapper.batch", on_call=5, corrupt=200.0)
    pol = TrainingHealthPolicy(grad_norm_limit=50.0, max_consecutive_bad=4)
    net = _reg_net(seed=5)
    _wrapper(net, ckpt=tmp / "wr", inj=inj, pol=pol).fit(
        ListDataSetIterator(batches))
    ref = _reg_net(seed=5)
    _wrapper(ref).fit(ListDataSetIterator(batches[:5] + batches[6:]))
    return {"counts": pol.counts, "events": _events(pol),
            "iterations": net.conf.iteration_count,
            "ref_iterations": ref.conf.iteration_count,
            "params": net.params(), "ref_params": ref.params()}


def _wrapper_nan_round(tmp):
    batches = list(_data(64, seed=8).batch_by(16))
    inj = FaultInjector(seed=0)
    inj.plan("wrapper.batch", on_call=1, corrupt="nan")
    pol = TrainingHealthPolicy(max_consecutive_bad=4)
    net = _net(seed=8)
    pw = _wrapper(net, inj=inj, pol=pol)
    snaps = []
    for b in batches:
        pw.fit(ListDataSetIterator([b]))
        snaps.append(net.params())
    return {"counts": pol.counts, "snaps": snaps,
            "iterations": net.conf.iteration_count}


def _wrapper_abort(tmp):
    batches = list(_data(128, seed=9).batch_by(16))
    inj = FaultInjector(seed=0)
    inj.plan("wrapper.batch", on_calls=[2, 3], corrupt="nan")
    pol = TrainingHealthPolicy(max_consecutive_bad=2)
    try:
        _wrapper(_net(seed=9), inj=inj, pol=pol).fit(
            ListDataSetIterator(batches))
        raised = None
    except TrainingDivergedError as e:
        raised = str(e)
    return {"counts": pol.counts, "raised": raised,
            "diagnose": pol.diagnose()}


def _wrapper_no_checkpoint(tmp):
    batches = list(_data(64, seed=10).batch_by(16))
    inj = FaultInjector(seed=0)
    inj.plan("wrapper.batch", on_call=1, corrupt=200.0)
    pol = TrainingHealthPolicy(grad_norm_limit=50.0, max_consecutive_bad=4)
    net = _reg_net(seed=10)
    _wrapper(net, inj=inj, pol=pol).fit(ListDataSetIterator(batches))
    return {"counts": pol.counts, "iterations": net.conf.iteration_count,
            "finite": bool(np.isfinite(net.params()).all())}


def _master(ckpt=None, inj=None, pol=None):
    b = (ParameterAveragingTrainingMaster.Builder(batch_size_per_worker=8)
         .workers(WORLD).averaging_frequency(2)
         .rdd_training_approach("direct"))
    if ckpt is not None:
        b = b.checkpoint_directory(str(ckpt))
    if inj is not None:
        b = b.fault_injector(inj)
    if pol is not None:
        b = b.health_policy(pol)
    return b.build()


def _master_kstep(tmp):
    ds = _data(128, seed=12)        # 8 global batches of 16: 4 rounds of 2

    def injector(rounds):
        inj = FaultInjector(seed=0)
        inj.plan("wrapper.batch", on_call=2, corrupt="nan")
        if rounds == 4:
            inj.plan("wrapper.batch", on_call=6, corrupt=300.0)
        return inj

    pol = TrainingHealthPolicy(grad_norm_limit=50.0, max_consecutive_bad=4)
    net = _reg_net(seed=12)
    _master(ckpt=tmp / "tm", inj=injector(4), pol=pol).execute_training(
        net, ds)
    # the master run that stops after round 3 (the NaN batch included)
    ref_pol = TrainingHealthPolicy(grad_norm_limit=50.0,
                                   max_consecutive_bad=4)
    ref = _reg_net(seed=12)
    _master(inj=injector(3), pol=ref_pol).execute_training(
        ref, DataSet(ds.features[:96], ds.labels[:96]))
    return {"counts": pol.counts, "events": _events(pol),
            "consecutive_bad": pol.consecutive_bad,
            "iterations": net.conf.iteration_count,
            "params": net.params(), "ref_params": ref.params(),
            "ref_iterations": ref.conf.iteration_count}


CASES = {"wrapper_rollback": _wrapper_rollback,
         "wrapper_nan_round": _wrapper_nan_round,
         "wrapper_abort": _wrapper_abort,
         "wrapper_no_checkpoint": _wrapper_no_checkpoint,
         "master_kstep": _master_kstep}


def _rank_main(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    out = {name: fn(Path(out_dir)) for name, fn in CASES.items()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of every case (the ranks share the checkpoint
    directories: rank 0 writes, both restore)."""
    tmp = tmp_path_factory.mktemp("health_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(tmp / "store"),
         str(tmp)], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * WORLD, "\n".join(
        f"rank {r} exit {c}:\n{(tmp / f'rank{r}.log').read_text()[-3000:]}"
        for r, c in enumerate(codes))
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def test_wrapper_rollback_completes_and_is_bit_comparable(ranks):
    for res in ranks:
        r = res["wrapper_rollback"]
        assert r["counts"]["spikes"] == 1 and r["counts"]["rollbacks"] == 1
        rb = [e for e in r["events"] if e["kind"] == "rollback"][0]
        assert rb["restoredRound"] == 5
        assert r["iterations"] == r["ref_iterations"] == 7
        np.testing.assert_array_equal(r["params"], r["ref_params"])
    np.testing.assert_array_equal(ranks[0]["wrapper_rollback"]["params"],
                                  ranks[1]["wrapper_rollback"]["params"])


def test_wrapper_nan_round_skipped_params_identical(ranks):
    for res in ranks:
        r = res["wrapper_nan_round"]
        assert r["counts"]["skips"] == 1 and r["counts"]["ok"] == 3
        np.testing.assert_array_equal(r["snaps"][1], r["snaps"][0])
        assert not np.array_equal(r["snaps"][2], r["snaps"][1])
        assert np.isfinite(r["snaps"][-1]).all()
        assert r["iterations"] == 4


def test_wrapper_consecutive_faults_abort_with_diagnostic(ranks):
    for res in ranks:
        r = res["wrapper_abort"]
        assert r["raised"] is not None and "offending rounds" in r["raised"]
        assert r["counts"]["aborts"] == 1
        assert "[3, 4]" in r["diagnose"]


def test_wrapper_rollback_without_checkpoint_degrades_to_count(ranks):
    for res in ranks:
        r = res["wrapper_no_checkpoint"]
        assert r["counts"]["spikes"] == 1
        assert r["counts"]["rollbacks"] == 0
        assert r["iterations"] == 4 and r["finite"]


def test_master_kstep_nan_skip_and_divergence_rollback(ranks):
    for res in ranks:
        r = res["master_kstep"]
        # the NaN global batch is one skipped local step on each rank: a
        # partial round (2 of its 4 local steps), counted, not escalated
        assert r["counts"]["skips"] == WORLD
        partial = [e for e in r["events"]
                   if e["kind"] == "skip" and "partial" in e["reason"]]
        assert partial and partial[0]["reason"].startswith(
            f"{WORLD}/{2 * WORLD}")
        assert np.isfinite(partial[0]["score"])
        assert r["consecutive_bad"] == 1
        assert r["counts"]["spikes"] == 1 and r["counts"]["rollbacks"] == 1
        rb = [e for e in r["events"] if e["kind"] == "rollback"][0]
        assert rb["restoredRound"] == 3
        assert r["iterations"] == r["ref_iterations"] == 6
        np.testing.assert_array_equal(r["params"], r["ref_params"])
    np.testing.assert_array_equal(ranks[0]["master_kstep"]["params"],
                                  ranks[1]["master_kstep"]["params"])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
