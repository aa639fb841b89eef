"""Graph vertex configurations for ComputationGraph: port of
deeplearning4j_tpu/nn/conf/graph_vertices.py (the same vertices and JSON;
each vertex a plain function on tensors, autograd for the backward).

The feature axis is dim 1 of the port's NCHW images and the last axis
otherwise, where the reference reads the last axis of NHWC
(`activations.feature_dim`).

Masks: a vertex receives the per-input mask list and returns its output mask
(default: first non-None input mask).
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

import torch

from ..activations import feature_dim

from .input_type import (ConvolutionalInputType, FeedForwardInputType,
                         InputType, RecurrentInputType)
from .preprocessors import from_nhwc, to_nhwc

VERTEX_REGISTRY = {}


def register_vertex(name):
    def deco(cls):
        VERTEX_REGISTRY[name] = cls
        cls.vertex_type = name
        return cls
    return deco


@dataclass
class GraphVertexConf:
    """Base for non-layer vertices."""

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        raise NotImplementedError

    def get_output_type(self, input_types):
        raise NotImplementedError

    def output_mask(self, masks):
        if masks:
            for m in masks:
                if m is not None:
                    return m
        return None

    # -- serde ----------------------------------------------------------
    def to_dict(self):
        d = {"type": self.vertex_type}
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        typ = d.pop("type")
        if typ not in VERTEX_REGISTRY:
            raise ValueError(f"Unknown vertex type '{typ}'. "
                             f"Known: {sorted(VERTEX_REGISTRY)}")
        klass = VERTEX_REGISTRY[typ]
        valid = {f.name for f in fields(klass)}
        kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in d.items() if k in valid}
        return klass(**kwargs)


@register_vertex("merge")
@dataclass
class MergeVertex(GraphVertexConf):
    """Concatenate along the feature/channel axis.
    reference: nn/graph/vertex/impl/MergeVertex.java."""

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        return torch.cat(inputs, dim=feature_dim(inputs[0]))

    def get_output_type(self, input_types):
        t0 = input_types[0]
        if isinstance(t0, FeedForwardInputType):
            return InputType.feed_forward(sum(t.size for t in input_types))
        if isinstance(t0, RecurrentInputType):
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.time_series_length)
        if isinstance(t0, ConvolutionalInputType):
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in input_types))
        raise ValueError(f"MergeVertex: unsupported input type {t0}")


@register_vertex("elementwise")
@dataclass
class ElementWiseVertex(GraphVertexConf):
    """Element-wise Add/Subtract/Product/Average/Max over equal-shape inputs.
    reference: nn/graph/vertex/impl/ElementWiseVertex.java (Op enum)."""
    op: str = "add"

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("ElementWiseVertex(subtract) needs 2 inputs")
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op in ("average", "avg"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out / float(len(inputs))
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown ElementWiseVertex op '{self.op}'")

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex("subset")
@dataclass
class SubsetVertex(GraphVertexConf):
    """Feature-axis subset [from_idx, to_idx] INCLUSIVE (reference
    nn/conf/graph/SubsetVertex.java semantics)."""
    from_idx: int = 0
    to_idx: int = 0

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        return x.narrow(feature_dim(x), self.from_idx,
                        self.to_idx - self.from_idx + 1)

    def get_output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if isinstance(t, RecurrentInputType):
            return InputType.recurrent(n, t.time_series_length)
        if isinstance(t, ConvolutionalInputType):
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)


@register_vertex("stack")
@dataclass
class StackVertex(GraphVertexConf):
    """Concatenate along the batch (first) axis — used for sharing one layer
    across several inputs. reference: nn/graph/vertex/impl/StackVertex.java."""

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        return torch.cat(inputs, dim=0)

    def get_output_type(self, input_types):
        return input_types[0]

    def output_mask(self, masks):
        if masks and all(m is not None for m in masks):
            return torch.cat(masks, dim=0)
        return None


@register_vertex("unstack")
@dataclass
class UnstackVertex(GraphVertexConf):
    """Inverse of StackVertex: take batch slice `from_idx` of `stack_size`.
    reference: nn/graph/vertex/impl/UnstackVertex.java."""
    from_idx: int = 0
    stack_size: int = 1

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex("scale")
@dataclass
class ScaleVertex(GraphVertexConf):
    """Multiply by a fixed scalar. reference: nn/conf/graph/ScaleVertex.java."""
    scale_factor: float = 1.0

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        return x * self.scale_factor

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex("l2")
@dataclass
class L2Vertex(GraphVertexConf):
    """Pairwise L2 distance between two inputs -> [batch, 1].
    reference: nn/graph/vertex/impl/L2Vertex.java."""
    eps: float = 1e-8

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        a, b = inputs
        d = a - b
        dims = tuple(range(1, d.ndim))
        return torch.sqrt((d * d).sum(dim=dims) + self.eps)[:, None]

    def get_output_type(self, input_types):
        return InputType.feed_forward(1)


@register_vertex("l2normalize")
@dataclass
class L2NormalizeVertex(GraphVertexConf):
    """x / ||x||_2 per example. reference: nn/graph/vertex/impl/L2NormalizeVertex.java."""
    eps: float = 1e-8

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        dims = tuple(range(1, x.ndim))
        n = torch.sqrt((x * x).sum(dim=dims, keepdim=True) + self.eps)
        return x / n

    def get_output_type(self, input_types):
        return input_types[0]


@register_vertex("preprocessor")
@dataclass
class PreprocessorVertex(GraphVertexConf):
    """Wraps an InputPreProcessor as a standalone vertex.
    reference: nn/graph/vertex/impl/PreprocessorVertex.java."""
    preprocessor: object = None

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        return self.preprocessor.pre_process(x)

    def get_output_type(self, input_types):
        return self.preprocessor.get_output_type(input_types[0])

    def to_dict(self):
        return {"type": "preprocessor",
                "preprocessor": self.preprocessor.to_dict()}

    @classmethod
    def from_dict(cls, d):
        from .preprocessors import InputPreProcessor
        return cls(preprocessor=InputPreProcessor.from_dict(d["preprocessor"]))


@register_vertex("lasttimestep")
@dataclass
class LastTimeStepVertex(GraphVertexConf):
    """[B,T,F] -> [B,F]: last timestep, or last UNMASKED timestep when the
    named input carries a mask. reference:
    nn/graph/vertex/impl/rnn/LastTimeStepVertex.java."""
    mask_input_name: str = None

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        m = masks[0] if masks else None
        if m is None:
            return x[:, -1]
        idx = (m != 0).sum(dim=1) - 1   # [B]
        idx = torch.clamp(idx, 0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def get_output_type(self, input_types):
        t = input_types[0]
        return InputType.feed_forward(t.size)

    def output_mask(self, masks):
        return None   # output is per-example, no time axis left


@register_vertex("duplicatetotimeseries")
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[B,F] -> [B,T,F], T taken from a reference sequence input (second
    input). reference: nn/graph/vertex/impl/rnn/DuplicateToTimeSeriesVertex.java
    (there T comes from a named graph input; here wire that input as input #2)."""

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        x, ref = inputs
        T = ref.shape[1]
        return x[:, None, :].expand(x.shape[0], T, x.shape[1])

    def get_output_type(self, input_types):
        t, ref = input_types
        tl = ref.time_series_length if isinstance(ref, RecurrentInputType) else -1
        return InputType.recurrent(t.size, tl)

    def output_mask(self, masks):
        return masks[1] if masks and len(masks) > 1 else None


@register_vertex("reshape")
@dataclass
class ReshapeVertex(GraphVertexConf):
    """Reshape trailing dims (batch preserved), in the reference's NHWC
    terms. reference: nn/conf/graph/ReshapeVertex.java."""
    shape: tuple = None

    def forward(self, inputs, *, masks=None, train=False, rng=None):
        (x,) = inputs
        if x.ndim == 4:
            x = to_nhwc(x)
        x = x.reshape((x.shape[0],) + tuple(self.shape))
        return from_nhwc(x) if x.ndim == 4 else x

    def get_output_type(self, input_types):
        import numpy as _np
        if len(self.shape) == 1:
            return InputType.feed_forward(int(self.shape[0]))
        if len(self.shape) == 2:
            return InputType.recurrent(int(self.shape[1]))
        if len(self.shape) == 3:
            return InputType.convolutional(*[int(s) for s in self.shape])
        return InputType.feed_forward(int(_np.prod(self.shape)))
