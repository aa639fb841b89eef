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
