"""The port's collective cost telemetry (`parallel/mesh_cost.py`).

The HLO parser is a copy of the reference's: every string of the
reference's own tests (tests/test_collective_budget.py:186's variadic
async case among them) and a few more give the same footprint through both
modules. The recorder counts what the port's collective helpers report, by
the reference's op names; `run_recorded` puts the tensors and generators it
was given back bit for bit. The committed 4-rank budget
(`tests/fixtures/collective_budgets_torch.json`) names every mode of
`graft_entry.dryrun_multichip`, whose run on CPU ranks lives in
test_torch_graft_entry.py.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel import mesh_cost, sharding

HLO = [
    "  %r = f32[32]{0} all-reduce(f32[32] %x), replica_groups={}",
    ("  %rs = (f32[32]{0}, f32[32]{0}) all-reduce-start(f32[32] %x), "
     "replica_groups={}"),
    ("  %ar = (f32[128,4]{1,0}, f32[64]{0}) "
     "all-reduce(f32[128,4] %a, f32[64] %b), replica_groups={}"),
    ("  %ars = (f32[128,4]{1,0}, f32[64]{0}, f32[128,4]{1,0}, "
     "f32[64]{0}) all-reduce-start(f32[128,4] %a, f32[64] %b), "
     "replica_groups={}"),
    ("  %ars = (f32[128,4]{1,0}, f32[64]{0}, f32[128,4]{1,0}, "
     "f32[64]{0}, u32[], u32[]) all-reduce-start("
     "f32[128,4] %a, f32[64] %b), replica_groups={}"),
    "  %ag = bf16[8,128]{1,0} all-gather(bf16[2,128] %p), dimensions={0}",
    ("  %cp = (s32[4,4]{1,0}, s32[4,4]{1,0}, u32[]) "
     "collective-permute-start(s32[4,4] %q), source_target_pairs={{0,1}}"),
    "  %a2a = f16[4,16]{1,0} all-to-all(f16[4,16] %z), dimensions={0}",
    "  %rs2 = f64[3]{0} reduce-scatter(f64[12] %w), dimensions={0}",
    "  %x = f32[4]{0} add(f32[4] %a, f32[4] %b)",
]


@pytest.mark.parametrize("i", range(len(HLO)))
def test_hlo_parser_is_the_reference_s(i):
    from deeplearning4j_tpu.parallel import mesh_cost as J
    text = HLO[i]
    assert mesh_cost.hlo_collective_footprint(text) == \
        J.hlo_collective_footprint(text)
    assert mesh_cost.shape_bytes(text) == J.shape_bytes(text)


def test_variadic_async_collective_equals_sync():
    sync = mesh_cost.hlo_collective_footprint(HLO[2])["all-reduce"]["bytes"]
    assert sync == 128 * 4 * 4 + 64 * 4
    assert mesh_cost.hlo_collective_footprint(HLO[3])["all-reduce"] == \
        {"count": 1, "bytes": sync}
    assert mesh_cost.hlo_collective_footprint(HLO[4])["all-reduce"][
        "bytes"] == sync + 2 * mesh_cost.shape_bytes("u32[]")
    whole = mesh_cost.hlo_collective_footprint("\n".join(HLO))
    assert mesh_cost.footprint_totals(whole) == {
        "count": sum(r["count"] for r in whole.values()),
        "bytes": sum(r["bytes"] for r in whole.values())}
    assert set(whole) == {"all-reduce", "all-gather", "collective-permute",
                          "all-to-all", "reduce-scatter"}


def test_recorder_counts_by_op_and_nests():
    t = torch.zeros(3, 5, dtype=torch.bfloat16)
    sharding.record("all-reduce", t)            # no recorder: nothing
    with mesh_cost.recording() as outer:
        sharding.record("all-gather", t)
        with mesh_cost.recording() as inner:
            sharding.record("all-gather", 7)
            sharding.record("all-to-all", torch.zeros(2))
    assert outer == {"all-gather": {"count": 2, "bytes": 30 + 7},
                     "all-to-all": {"count": 1, "bytes": 8}}
    assert inner == {"all-gather": {"count": 1, "bytes": 7},
                     "all-to-all": {"count": 1, "bytes": 8}}
    assert sharding._RECORDERS == []


def test_one_rank_collectives_record_nothing():
    """On one rank (no group) the helpers are the identity and count
    nothing, as a one-device program has no collective."""
    mesh = sharding.make_mesh(device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    with mesh_cost.recording() as rec:
        assert sharding.all_reduce_mean([x], mesh)[0] is x
        assert sharding.all_gather(x, None, 1) is x
        assert sharding.all_to_all(x, None) is x
        assert sharding.copy_to(x, None) is x
        assert sharding.reduce_from(x, None) is x
    assert rec == {}


def test_run_recorded_puts_everything_back():
    a = torch.randn(4, generator=torch.Generator().manual_seed(0))
    before = a.clone()
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()

    def step():
        a.add_(1.0)
        torch.rand(3, generator=gen)
        sharding.record("all-reduce", a)

    lowered = mesh_cost.run_recorded(step, [a], "cpu", generators=(gen,))
    assert torch.equal(a, before) and torch.equal(gen.get_state(), state)
    assert mesh_cost.lowered_footprint(lowered) == (
        {"all-reduce": {"count": 1, "bytes": 16}}, None)


def test_committed_budget_names_every_mode():
    path = (Path(__file__).resolve().parent / "fixtures"
            / "collective_budgets_torch.json")
    budget = json.loads(path.read_text())
    assert set(budget) == {"dp_tp_zero1", "param_averaging",
                           "ring_attention_sp", "gpipe_pp",
                           "dp_tp_pp_3axis", "moe_ep", "dp_ep_moe_top2",
                           "w2v_model_sharded"}
    for name, b in budget.items():
        assert b["count"] == sum(r["count"] for r in b["ops"].values())
        assert b["bytes"] == sum(r["bytes"] for r in b["ops"].values())
    assert "collective-permute" in budget["ring_attention_sp"]["ops"]
    assert "all-to-all" in budget["moe_ep"]["ops"]
    assert np.isfinite(budget["dp_tp_zero1"]["bytes"])
