"""The port's counterpart of the repository's `__graft_entry__.entry()`:
the flagship model's inference forward on one card.

`entry(device=None)` returns `(forward, (params, x))`: `forward(params, x)`
is the ResNet-50 ComputationGraph's inference forward (224x224x3, bf16,
1000 classes) on the given parameters (the f32 masters, keyed by vertex
name as `ComputationGraph._params` holds them; the forward casts them to
bf16), and `x` is `np.random.default_rng(0).random((8, 224, 224, 3))` as
float32 on the device, NHWC. The output is the [8, 1000] bf16 softmax.

The reference's `dryrun_multichip` drives the tensor, pipeline, ZeRO and
MoE modes, which are not ported yet (ROADMAP.md queue 1 item 20).
"""
from __future__ import annotations

import numpy as np
import torch

from .common.device import card_numerics, resolve_device


def entry(device=None):
    """(forward, (params, x)) of the ResNet-50 inference forward, on the
    card unless `device` says otherwise."""
    from .models.zoo.resnet import resnet50

    device = resolve_device(device)
    net = resnet50(height=224, width=224, channels=3, num_classes=1000,
                   data_type="bfloat16", device=device)
    params = net._params
    out_name = net.conf.network_outputs[0]

    def forward(params, x):
        with torch.no_grad(), card_numerics(net.device, net.compute_dtype):
            acts, *_ = net._apply_graph(net._cast_params(params),
                                        net._states(), net._inputs(x),
                                        train=False, rng=None)
        return acts[out_name]

    x = torch.as_tensor(np.random.default_rng(0).random((8, 224, 224, 3)),
                        dtype=torch.float32, device=device)
    return forward, (params, x)
