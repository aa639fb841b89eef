"""Attention layers: port of deeplearning4j_tpu/nn/conf/layers/attention.py.

Multi-head self-attention as a layer over [batch, time, features], with
optional causal masking and a key mask. Locally it runs the port's
`parallel.ring_attention.blockwise_attention`; with
`with_sequence_parallel(group)` each rank of a `torch.distributed` group
holds one chunk of the sequence and the layer runs
`ring_self_attention` over the group (the reference shards over a mesh
axis). Both are the reference's einsum route: plain torch, no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ....parallel.ring_attention import (blockwise_attention,
                                         ring_self_attention)
from ... import weights
from ..input_type import InputType, RecurrentInputType
from .base import LayerConf, apply_input_dropout, register_layer


@register_layer("selfattention")
@dataclass
class SelfAttentionLayer(LayerConf):
    """Multi-head self-attention: out = proj(softmax(QK^T/sqrt(d))V)."""
    n_in: int = None
    n_out: int = None          # model dim of the output projection
    n_heads: int = 4
    causal: bool = False
    # the process group of the sequence-parallel route; not configuration
    # (no dataclass field, so never in the JSON)
    _group = None
    _sequence_parallel = False

    def with_sequence_parallel(self, group=None):
        """Run attention as a ring over the ranks of `group` (default: the
        world): every rank calls the layer on its own chunk of the
        sequence, [B, T/n, D], chunks in rank order, and gets its chunk of
        the output."""
        self._group = group
        self._sequence_parallel = True
        return self

    def set_n_in(self, input_type, override=True):
        if isinstance(input_type, RecurrentInputType):
            if self.n_in is None or override:
                self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out,
                                   getattr(input_type, "time_series_length",
                                           -1))

    def init_params(self, gen, dtype=torch.float32):
        if self.n_in % self.n_heads != 0:
            raise ValueError(
                f"n_in={self.n_in} not divisible by n_heads={self.n_heads}")
        D = self.n_in

        def mk(o):
            return weights.init(gen, (D, o), D, o,
                                self.weight_init or "xavier", self.dist, dtype)

        return {"Wq": mk(D), "Wk": mk(D), "Wv": mk(D), "Wo": mk(self.n_out),
                "b": torch.zeros(self.n_out, dtype=dtype)}

    def forward(self, params, x, *, train=False, rng=None, mask=None,
                state=None):
        x = apply_input_dropout(self, x, train, rng)
        B, T, D = x.shape
        H = self.n_heads
        q, k, v = ((x @ params[w]).reshape(B, T, H, D // H)
                   for w in ("Wq", "Wk", "Wv"))
        kv_mask = mask.to(x.dtype) if mask is not None else None
        if self._sequence_parallel:
            out = ring_self_attention(q, k, v, group=self._group,
                                      causal=self.causal, kv_mask=kv_mask)
        else:
            out = blockwise_attention(q, k, v, kv_mask=kv_mask,
                                      causal=self.causal)
        out = out.reshape(B, T, D) @ params["Wo"] + params["b"]
        if mask is not None:
            out = out * mask[:, :, None].to(out.dtype)
        return out
