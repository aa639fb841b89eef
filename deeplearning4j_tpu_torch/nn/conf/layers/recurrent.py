"""Recurrent layers: port of deeplearning4j_tpu/nn/conf/layers/recurrent.py
(GravesLSTM, GravesBidirectionalLSTM, SimpleRnn).

The same fields, JSON, parameter names and layout as the reference, whose
math is DL4J's LSTMHelpers (Graves LSTM with peepholes):
  a = actFn(x W_a + h_{t-1} U_a + b_a)                (block input)
  i = gateFn(x W_i + h U_i + p_i * c_{t-1} + b_i)
  f = gateFn(x W_f + h U_f + p_f * c_{t-1} + b_f)
  c_t = f * c_{t-1} + i * a
  o = gateFn(x W_o + h U_o + p_o * c_t + b_o)
  h_t = o * actFn(c_t)
Parameters: W [nIn, 4H] (gate order a, i, f, o), RW [H, 4H], b [4H] with
the forget gate's slice set to forgetGateBiasInit, peep [3H] (p_i, p_f,
p_o), zero at init.

Where the reference runs the sequence as one `lax.scan`, the port runs a
Python loop over the time steps: the input projection x @ W + b is hoisted
out of it as one [B*T, nIn] x [nIn, 4H] product (cuBLAS), and each step is
the recurrent product h @ RW plus the gate math as eager ops; autograd
through the loop is the backward. `torch.nn.LSTM` (cuDNN) has no
peepholes, so it computes another function and is not used.

Masking (per-example variable length), with the reference's arithmetic so
that NaN and inf propagate the same way: a masked step emits zero
(m * h_new) and carries the state through unchanged
(m * h_new + (1 - m) * h).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import activations, weights
from ..input_type import InputType, RecurrentInputType
from .base import LayerConf, apply_input_dropout, register_layer


class BaseRecurrentLayer(LayerConf):
    """Base for layers that carry sequence state between calls (TBPTT
    segments, `rnn_time_step`): `init_carry` gives the zero state,
    `forward_with_carry` runs a sequence from a state and returns the
    final one."""

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        raise NotImplementedError

    def forward_with_carry(self, params, x, carry, *, train=False, rng=None,
                           mask=None):
        raise NotImplementedError

    def is_recurrent(self):
        return True

    def forward(self, params, x, *, train=False, rng=None, mask=None,
                state=None):
        """The sequence from a zero state: x [B, T, nIn] -> [B, T, H]."""
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        out, _ = self.forward_with_carry(params, x, carry, train=train,
                                         rng=rng, mask=mask)
        return out


def _recurrent_n_in(layer, input_type, override):
    if layer.n_in is None or override:
        if isinstance(input_type, RecurrentInputType):
            layer.n_in = input_type.size


def _steps(x, mask):
    """x [B, T, F] and mask [B, T] (or None) as per-step views: T tensors
    [B, F] and T masks [B, 1] in x's dtype. `unbind`'s backward is one
    stack, where indexing each step would scatter into a zero tensor of
    the whole sequence per step."""
    xs = x.unbind(1)
    if mask is None:
        return xs, None
    return xs, mask.to(x.dtype)[..., None].unbind(1)


def _zeros(batch_size, width, dtype, device):
    return torch.zeros(batch_size, width, dtype=dtype, device=device)


@register_layer("graveslstm")
@dataclass
class GravesLSTM(BaseRecurrentLayer):
    n_in: int = None
    n_out: int = None
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    # The reference's lax.scan unroll factor, kept so the JSON round-trips.
    # The port's loop is eager, so it changes nothing here.
    scan_unroll: int = 1

    def set_n_in(self, input_type, override=True):
        if self.n_in is None or override:
            if isinstance(input_type, RecurrentInputType):
                self.n_in = input_type.size
            else:
                from .feedforward import _ff_size
                self.n_in = _ff_size(input_type)

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        # the reference's fans: fan-out H, not 4H
        H = self.n_out
        W = weights.init(gen, (self.n_in, 4 * H), self.n_in, H,
                         self.weight_init, self.dist, dtype)
        RW = weights.init(gen, (H, 4 * H), H, H, self.weight_init, self.dist,
                          dtype)
        b = torch.zeros(4 * H, dtype=dtype)
        b[2 * H:3 * H] = float(self.forget_gate_bias_init)
        return {"W": W, "RW": RW, "b": b,
                "peep": torch.zeros(3 * H, dtype=dtype)}

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        H = self.n_out
        return {"h": _zeros(batch_size, H, dtype, device),
                "c": _zeros(batch_size, H, dtype, device)}

    def forward_with_carry(self, params, x, carry, *, train=False, rng=None,
                           mask=None):
        """x [B, T, nIn] from `carry` -> ([B, T, H], final carry)."""
        act = activations.get(self.activation or "tanh")
        gate = activations.get(self.gate_activation)
        x = apply_input_dropout(self, x, train, rng)
        xz = x @ params["W"] + params["b"]          # [B, T, 4H], hoisted
        RW = params["RW"]
        pi, pf, po = params["peep"].chunk(3)
        h = carry["h"].to(x.dtype)
        c = carry["c"].to(x.dtype)
        xs, ms = _steps(xz, mask)
        outs = []
        for t, xz_t in enumerate(xs):
            za, zi, zf, zo = (xz_t + h @ RW).chunk(4, dim=-1)
            a = act(za)
            i = gate(zi + pi * c)
            f = gate(zf + pf * c)
            c_new = f * c + i * a
            o = gate(zo + po * c_new)
            h_new = o * act(c_new)
            if ms is None:
                h, c = h_new, c_new
                outs.append(h_new)
            else:
                m = ms[t]
                h = m * h_new + (1.0 - m) * h
                c = m * c_new + (1.0 - m) * c
                outs.append(m * h_new)
        return torch.stack(outs, dim=1), {"h": h, "c": c}


@register_layer("gravesbidirectionallstm")
@dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayer):
    """Two GravesLSTM passes, forward and over the time-reversed sequence,
    their outputs summed (the backward one flipped back). Parameters: the
    forward pass's W, RW, b, peep and the backward pass's W_bw, RW_bw,
    b_bw, peep_bw."""
    n_in: int = None
    n_out: int = None
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    scan_unroll: int = 1                 # see GravesLSTM.scan_unroll

    def _sub(self):
        sub = GravesLSTM(n_in=self.n_in, n_out=self.n_out,
                         forget_gate_bias_init=self.forget_gate_bias_init,
                         gate_activation=self.gate_activation,
                         scan_unroll=self.scan_unroll)
        sub.activation = self.activation
        sub.weight_init = self.weight_init
        sub.dist = self.dist
        return sub            # no dropout: applied once, here

    def set_n_in(self, input_type, override=True):
        _recurrent_n_in(self, input_type, override)

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        sub = self._sub()
        fw = sub.init_params(gen, dtype)
        bw = sub.init_params(gen, dtype)
        return dict(fw, **{f"{k}_bw": v for k, v in bw.items()})

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        z = _zeros(batch_size, self.n_out, dtype, device)
        return {"h": z, "c": z, "h_bw": z, "c_bw": z}

    def forward_with_carry(self, params, x, carry, *, train=False, rng=None,
                           mask=None):
        sub = self._sub()
        x = apply_input_dropout(self, x, train, rng)
        names = ("W", "RW", "b", "peep")
        out_f, cf = sub.forward_with_carry(
            {k: params[k] for k in names}, x,
            {"h": carry["h"], "c": carry["c"]}, mask=mask)
        out_b, cb = sub.forward_with_carry(
            {k: params[f"{k}_bw"] for k in names}, x.flip(1),
            {"h": carry["h_bw"], "c": carry["c_bw"]},
            mask=None if mask is None else mask.flip(1))
        return out_f + out_b.flip(1), {"h": cf["h"], "c": cf["c"],
                                       "h_bw": cb["h"], "c_bw": cb["c"]}


@register_layer("simplernn")
@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: h_t = act(x W + h_{t-1} RW + b)."""
    n_in: int = None
    n_out: int = None

    def set_n_in(self, input_type, override=True):
        _recurrent_n_in(self, input_type, override)

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)

    def init_params(self, gen, dtype=torch.float32):
        W = weights.init(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         self.weight_init, self.dist, dtype)
        RW = weights.init(gen, (self.n_out, self.n_out), self.n_out,
                          self.n_out, self.weight_init, self.dist, dtype)
        return {"W": W, "RW": RW, "b": torch.zeros(self.n_out, dtype=dtype)}

    def init_carry(self, batch_size, dtype=torch.float32, device=None):
        return {"h": _zeros(batch_size, self.n_out, dtype, device)}

    def forward_with_carry(self, params, x, carry, *, train=False, rng=None,
                           mask=None):
        act = activations.get(self.activation or "tanh")
        x = apply_input_dropout(self, x, train, rng)
        xz = x @ params["W"] + params["b"]
        RW = params["RW"]
        h = carry["h"].to(x.dtype)
        xs, ms = _steps(xz, mask)
        outs = []
        for t, xz_t in enumerate(xs):
            h_new = act(xz_t + h @ RW)
            if ms is None:
                h = h_new
                outs.append(h_new)
            else:
                m = ms[t]
                h = m * h_new + (1.0 - m) * h
                outs.append(m * h_new)
        return torch.stack(outs, dim=1), {"h": h}
