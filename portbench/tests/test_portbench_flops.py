"""The operation counts against the papers' and against torch's own
counter of the reference's products."""
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench.reference import common as C, resnet, vgg

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name, **small):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg.update(small)
    return cfg


def test_resnet50_forward_is_the_papers_3_8_gmac():
    # He et al. 2016, Table 1: 3.8e9 multiply-adds a 224x224 image (v1, the
    # stride on each stage's first 1x1; v1.5's 4.1e9 strides the 3x3)
    m = sum(flops.macs(p) for p in resnet.products(config("resnet50"), 1))
    assert m == pytest.approx(3.8e9, rel=0.02)


def test_vgg16_forward_is_the_papers_15_5_gmac():
    # Simonyan and Zisserman 2014, configuration D: 15.5e9 multiply-adds
    m = sum(flops.macs(p) for p in vgg.products(config("vgg16"), 1))
    assert m == pytest.approx(15.5e9, rel=0.01)


def test_parameter_counts_are_the_papers():
    def count(mod, name):
        return sum(int(torch.tensor(s).prod()) for _, _, s, _, _ in
                   mod.leaves(config(name)))
    assert count(resnet, "resnet50") == pytest.approx(25.6e6, rel=0.01)
    assert count(vgg, "vgg16") == 138_357_544


@pytest.mark.parametrize("family,name,small", [
    (resnet, "resnet50", dict(height=64, width=64, num_classes=10)),
    (vgg, "vgg16", dict(height=32, width=32, num_classes=10)),
])
def test_counts_match_torchs_counter(family, name, small):
    cfg = config(name, **small)
    batch = 2
    p = {k: t.requires_grad_() for k, t in
         C.make_params(family.leaves(cfg), 0, "cpu").items()}
    x = torch.rand(batch, 3, cfg["height"], cfg["width"])
    model = family.Model(cfg)
    gen = torch.Generator().manual_seed(0)
    with FlopCounterMode(display=False) as fwd:
        logits = model.logits(p, x, train=True, stats={},
                              **model.step_inputs(batch, gen, "cpu"))
    assert fwd.get_total_flops() == flops.forward_flops(
        family.products(cfg, batch))
    with FlopCounterMode(display=False) as both:
        logits = model.logits(p, x, train=True, stats={},
                              **model.step_inputs(batch, gen, "cpu"))
        logits.sum().backward()
    assert both.get_total_flops() == flops.train_flops(
        family.products(cfg, batch))
