"""The port's counterpart of `__graft_entry__.entry()`
(`deeplearning4j_tpu_torch/graft_entry.py`): `entry(device="cpu")` returns
`(forward, (params, x))`, and `forward(params, x)` traces to the [8, 1000]
bf16 ResNet-50 output without paying a full 224x224 bf16 forward on the
CPU: it runs under `FakeTensorMode`, which computes shapes and dtypes
only, the cheap guard the reference's test takes with `jax.eval_shape`
(tests/test_graft_entry.py). The input is the reference's:
`np.random.default_rng(0).random((8, 224, 224, 3))` as f32.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from deeplearning4j_tpu_torch.graft_entry import entry


def test_entry_traces_the_flagship_forward():
    fn, (params, x) = entry(device="cpu")
    assert x.dtype == torch.float32 and tuple(x.shape) == (8, 224, 224, 3)
    np.testing.assert_array_equal(
        x.numpy(), np.random.default_rng(0).random((8, 224, 224, 3))
        .astype(np.float32))
    assert set(params) >= {"stem_conv", "fc"}
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(params, x)
    assert isinstance(out, FakeTensor)
    assert tuple(out.shape) == (8, 1000) and out.dtype == torch.bfloat16


def test_forward_runs_on_the_given_parameters():
    """The forward reads the parameters it is handed, not the network's:
    zeroing the head's weight and bias makes every row uniform (softmax of
    zeros), traced on one example at 32x32 to stay cheap."""
    fn, (params, _) = entry(device="cpu")
    x = torch.rand((1, 32, 32, 3))
    zeroed = {k: dict(v) for k, v in params.items()}
    zeroed["fc"] = {n: torch.zeros_like(p) for n, p in params["fc"].items()}
    out = fn(zeroed, x)
    assert tuple(out.shape) == (1, 1000)
    torch.testing.assert_close(out.float(), torch.full((1, 1000), 1e-3),
                               rtol=0, atol=1e-5)
    assert not torch.equal(fn(params, x), out)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """`dryrun_multichip(4, device="cpu")` starts 4 gloo CPU ranks and runs
    every parallel mode (each checked inside against its one-rank
    computation), prints the reference's MULTICHIP_COST line, and passes
    the committed 4-rank budget's 2x gate. Without a device it asks for
    the card, and without one raises before starting a rank."""
    import json

    from deeplearning4j_tpu_torch.graft_entry import dryrun_multichip
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun_multichip(4)
    costs = dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    line = next(s for s in out.splitlines()
                if s.startswith("MULTICHIP_COST "))
    printed = json.loads(line[len("MULTICHIP_COST "):])
    assert printed["collectives"] == costs
    assert set(printed["timings_s"]) >= {"dp_tp_zero1", "gpipe_pp",
                                         "dp_tp_pp_3axis", "moe_ep"}
    assert "dryrun_multichip(4): ok" in out
    assert costs["gpipe_pp"]["ops"]["collective-permute"]["count"] == 9
    # three hops, each k and v [2, 4, 2, 16] f32 and the key mask [2, 4]
    assert costs["ring_attention_sp"]["ops"] == {
        "collective-permute": {"count": 3,
                               "bytes": 3 * (2 * 2 * 4 * 2 * 16 * 4 + 32)}}


@pytest.mark.gpu
def test_dryrun_multichip_on_two_card_ranks():
    """`dryrun_multichip(2, device="cuda")`: two gloo ranks on cuda:0 run
    every mode (the checks inside hold); the ring's flash hops launch K3
    twice on rank 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from deeplearning4j_tpu_torch import graft_entry
    costs = graft_entry.dryrun_multichip(2, device="cuda")
    assert "gpipe_pp" in costs and "w2v_model_sharded" in costs
    assert graft_entry.LAST_RUN["flash_launches"]["partial"] == 2
