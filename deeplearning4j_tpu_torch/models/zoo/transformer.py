"""Decoder-only transformer LM: port of
deeplearning4j_tpu/models/zoo/transformer.py (training with `fit_batch`,
inference with `logits`, `generate`, `generate_batch`).

Block = pre-LN multi-head causal self-attention + residual, then pre-LN GeLU
(tanh form, as `jax.nn.gelu`) MLP + residual. `attention="flash"` runs the
full causal forward through the CUDA flash kernels (`ops/flash_attention`):
K1 for inference; K2 forward and K4/K5 backward when `fit_batch` trains. The
KV-cache decode and the batched prefill use the dense attention, as in the
JAX package.

`fit_batch` is one step of SGD with momentum on the mean next-token cross
entropy, as the JAX package's jitted step: gradients by autograd, then the
update in place (`parallel/pipeline.sgd_momentum_update`), so parameter
names and the KV-cache paths are unchanged.

Weights keep the JAX package's orientation (`x @ W`, W is [in, out]) and its
nested names, so the state-dict key `blocks.0.attn.wqkv` is JAX's
`blocks[0]["attn"]["wqkv"]`, and the weight bridge
`TransformerLM.from_jax_params` is a copy.

Entry points run on the CUDA card unless the caller passes device="cpu";
with no card and no device given they raise.

The KV cache is updated in place (JAX returns a new one).

Not ported yet (ROADMAP.md queues them): `draft=` (speculative decoding)
and the serving programs of serving/decode.py.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...common.device import resolve_device
from ...ops.flash_attention import flash_attention
from ...parallel.pipeline import sgd_momentum_update

_NOT_PORTED = "is not ported yet; ROADMAP.md queues it"
_TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16}


def _param(t):
    return nn.Parameter(t)


class LayerNorm(nn.Module):
    def __init__(self, g, b):
        super().__init__()
        self.g, self.b = _param(g), _param(b)


class Attention(nn.Module):
    def __init__(self, wqkv, wo):
        super().__init__()
        self.wqkv, self.wo = _param(wqkv), _param(wo)


class MLP(nn.Module):
    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = _param(w1), _param(b1)
        self.w2, self.b2 = _param(w2), _param(b2)


class Block(nn.Module):
    """One block's parameters: ln1, attn, ln2, mlp."""

    def __init__(self, ln1, attn, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class Aux(nn.Module):
    """Token and position embeddings, final LayerNorm and LM head."""

    def __init__(self, tok, pos, lnf, head):
        super().__init__()
        self.tok, self.pos = _param(tok), _param(pos)
        self.lnf, self.head = lnf, _param(head)


def _layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * g + b


def _mlp_residual(p, x):
    """The second half of every block: x + MLP(LN2(x))."""
    h = _layer_norm(x, p.ln2.g, p.ln2.b)
    m = F.gelu(h @ p.mlp.w1 + p.mlp.b1, approximate="tanh")
    return x + m @ p.mlp.w2 + p.mlp.b2


def _normal(generator, shape, std, dtype, device):
    return (torch.randn(shape, generator=generator) * std).to(device=device,
                                                             dtype=dtype)


def _fresh_layer_norm(d, dtype, device):
    return LayerNorm(torch.ones(d, dtype=dtype, device=device),
                     torch.zeros(d, dtype=dtype, device=device))


def init_block(generator, d_model, n_heads, d_ff, dtype=torch.float32,
               device=None):
    """Random block parameters drawn from `generator` (a CPU generator, so a
    seed gives the same weights on every device)."""
    device = resolve_device(device)
    s_attn = 1.0 / math.sqrt(d_model)
    s_ff = 1.0 / math.sqrt(d_ff)
    normal = lambda shape, std: _normal(generator, shape, std, dtype, device)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return Block(
        _fresh_layer_norm(d_model, dtype, device),
        Attention(normal((d_model, 3 * d_model), s_attn),
                  normal((d_model, d_model), s_attn)),
        _fresh_layer_norm(d_model, dtype, device),
        MLP(normal((d_model, d_ff), s_attn), zeros(d_ff),
            normal((d_ff, d_model), s_ff), zeros(d_model)))


def causal_attention(x, wqkv, wo, n_heads, return_kv=False):
    """[B, T, D] causal MHA with dense scores. return_kv=True also yields the
    [B, T, H, hd] k/v panels (the prefill fills the KV cache from them)."""
    B, T, D = x.shape
    H = n_heads
    hd = D // H
    q, k, v = (x @ wqkv).split(D, -1)
    panels = lambda a: a.reshape(B, T, H, hd)
    heads = lambda a: panels(a).transpose(1, 2)        # [B, H, T, hd]
    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), -1).to(x.dtype)
    out = (att @ vh).transpose(1, 2).reshape(B, T, D) @ wo
    if return_kv:
        return out, panels(k), panels(v)
    return out


def flash_causal_attention(x, wqkv, wo, n_heads):
    """causal_attention through the flash kernel: the [T, T] scores never
    reach device memory. q, k, v go to the kernel as strided views."""
    B, T, D = x.shape
    H = n_heads
    split = lambda a: a.reshape(B, T, H, D // H)
    q, k, v = (x @ wqkv).split(D, -1)
    out = flash_attention(split(q), split(k), split(v), True)
    return out.reshape(B, T, D) @ wo


def make_block_fn(n_heads, attention="dense"):
    """block_fn(p, x) for one Block p; attention: "dense" or "flash"."""
    attn = (flash_causal_attention if attention == "flash"
            else causal_attention)

    def block_fn(p, x):
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        x = x + attn(h, p.attn.wqkv, p.attn.wo, n_heads)
        return _mlp_residual(p, x)

    return block_fn


def make_decode_block_fn(n_heads):
    """Single-token decode for one block with a KV cache:
    block_decode(p, x [B, D], cache {k, v: [B, L, H, hd]}, pos int)
      -> (y [B, D], cache)
    The new token's k/v are written at `pos` (in place), then the query
    attends to cache positions <= pos."""

    def block_decode(p, x, cache, pos):
        B, D = x.shape
        H = n_heads
        hd = D // H
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        q, k, v = (h @ p.attn.wqkv).split(D, -1)
        cache["k"][:, pos] = k.reshape(B, H, hd)
        cache["v"][:, pos] = v.reshape(B, H, hd)
        scores = torch.einsum("bhd,blhd->bhl", q.reshape(B, H, hd),
                              cache["k"]) / math.sqrt(hd)
        L = cache["k"].shape[1]
        keep = torch.arange(L, device=x.device) <= pos
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
        att = torch.softmax(scores.float(), -1).to(x.dtype)
        out = torch.einsum("bhl,blhd->bhd", att, cache["v"]).reshape(B, D)
        return _mlp_residual(p, x + out @ p.attn.wo), cache

    return block_decode


def prefill_panels(aux, blocks, tokens, n_heads):
    """The causal prompt forward: (h [B, P, D], [(k, v)] per layer, each
    [B, P, H, hd]), through the dense attention."""
    h = embed_fn(aux, tokens)
    panels = []
    for p in blocks:
        hn = _layer_norm(h, p.ln1.g, p.ln1.b)
        att, kp, vp = causal_attention(hn, p.attn.wqkv, p.attn.wo, n_heads,
                                       return_kv=True)
        h = _mlp_residual(p, h + att)
        panels.append((kp, vp))
    return h, panels


def prefill_forward(aux, blocks, tokens, n_heads, cache_len):
    """One causal forward over `tokens` [B, P] filling rows [0, P) of a
    length-`cache_len` KV cache per layer. Returns (h [B, P, D], cache)."""
    B, P = tokens.shape
    h, panels = prefill_panels(aux, blocks, tokens, n_heads)
    cache = []
    for kp, vp in panels:
        c = {"k": kp.new_zeros((B, cache_len) + kp.shape[2:]),
             "v": vp.new_zeros((B, cache_len) + vp.shape[2:])}
        c["k"][:, :P] = kp
        c["v"][:, :P] = vp
        cache.append(c)
    return h, cache


def init_kv_cache(n_layers, batch, max_len, d_model, n_heads,
                  dtype=torch.float32, device=None):
    device = resolve_device(device)
    hd = d_model // n_heads
    z = lambda: torch.zeros(batch, max_len, n_heads, hd, dtype=dtype,
                            device=device)
    return [{"k": z(), "v": z()} for _ in range(n_layers)]


def init_lm(vocab_size, d_model=128, n_heads=4, n_layers=4, d_ff=None,
            max_len=256, seed=0, dtype=torch.float32, device=None):
    """(aux, blocks) with random weights from `seed`. The draws come from
    a CPU torch.Generator, so a seed gives the same weights on any device
    (not the JAX package's weights: move those with
    `TransformerLM.from_jax_params`)."""
    device = resolve_device(device)
    d_ff = d_ff or 4 * d_model
    gen = torch.Generator().manual_seed(int(seed))
    normal = lambda shape, std: _normal(gen, shape, std, dtype, device)
    aux = Aux(normal((vocab_size, d_model), 0.02),
              normal((max_len, d_model), 0.02),
              _fresh_layer_norm(d_model, dtype, device),
              normal((d_model, vocab_size), 1.0 / math.sqrt(d_model)))
    blocks = [init_block(gen, d_model, n_heads, d_ff, dtype, device)
              for _ in range(n_layers)]
    return aux, blocks


def _from_numpy(a, dtype, device):
    a = np.asarray(a)
    if dtype is None:
        dtype = _TORCH_DTYPE[a.dtype.name]
    # a writable copy; ml_dtypes' bfloat16 has no torch counterpart in numpy
    a = np.array(a, np.float32 if a.dtype.name == "bfloat16" else a.dtype)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _params_from_jax(aux, blocks, dtype, device):
    """The JAX package's `(aux, blocks)` -> this module's (Aux, [Block]).
    Both packages store weights as `x @ W`, so nothing is transposed."""
    t = lambda a: _from_numpy(a, dtype, device)
    ln = lambda p: LayerNorm(t(p["g"]), t(p["b"]))
    port_aux = Aux(t(aux["tok"]), t(aux["pos"]), ln(aux["lnf"]),
                   t(aux["head"]))
    port_blocks = [
        Block(ln(p["ln1"]), Attention(t(p["attn"]["wqkv"]), t(p["attn"]["wo"])),
              ln(p["ln2"]), MLP(t(p["mlp"]["w1"]), t(p["mlp"]["b1"]),
                                t(p["mlp"]["w2"]), t(p["mlp"]["b2"])))
        for p in blocks]
    return port_aux, port_blocks


def embed_fn(aux, tokens):
    """[B, T] int tokens -> [B, T, D] activations."""
    return aux.tok[tokens] + aux.pos[:tokens.shape[-1]]


def logits_fn(aux, h):
    return _layer_norm(h, aux.lnf.g, aux.lnf.b) @ aux.head


def lm_loss(aux, h, targets):
    """Mean next-token cross entropy; h [B, T, D], targets [B, T] ints.
    The logits are cast to f32 before the log-softmax."""
    logp = torch.log_softmax(logits_fn(aux, h).float(), -1)
    return -logp.gather(-1, targets[..., None]).mean()


class TransformerLM(nn.Module):
    """Single-device training (`fit_batch`: SGD with momentum, learning
    rate `learning_rate`, momentum `momentum`) and inference (`logits`,
    `generate`, `generate_batch`). Runs on `device` (default: the CUDA card;
    pass device="cpu" for the CPU)."""

    def __init__(self, vocab_size, d_model=128, n_heads=4, n_layers=4,
                 d_ff=None, max_len=256, seed=0, dtype=torch.float32,
                 learning_rate=0.1, momentum=0.9, attention="dense",
                 device=None):
        super().__init__()
        aux, blocks = init_lm(vocab_size, d_model, n_heads, n_layers, d_ff,
                              max_len, seed, dtype, device)
        self._setup(aux, blocks, n_heads, attention, learning_rate, momentum)

    def _setup(self, aux, blocks, n_heads, attention, learning_rate,
               momentum):
        if attention not in ("dense", "flash"):
            raise ValueError(f"attention must be 'dense' or 'flash', "
                             f"not {attention!r}")
        self.aux = aux
        self.blocks = nn.ModuleList(blocks)
        self.n_heads = int(n_heads)
        self.attention = attention
        self.block_fn = make_block_fn(self.n_heads, attention)
        self._block_decode = make_decode_block_fn(self.n_heads)
        self.lr, self.mu = float(learning_rate), float(momentum)
        self._vel = None

    @classmethod
    def from_jax_params(cls, aux, blocks, n_heads, attention="dense",
                        dtype=None, device=None, learning_rate=0.1,
                        momentum=0.9):
        """The weight bridge: a model holding the JAX package's `(aux,
        blocks)` (nested dicts of numpy arrays, e.g. from `init_lm` there).
        dtype defaults to each array's own; bf16 goes through float32."""
        lm = cls.__new__(cls)
        nn.Module.__init__(lm)
        lm._setup(*_params_from_jax(aux, blocks, dtype,
                                    resolve_device(device)),
                  n_heads, attention, learning_rate, momentum)
        return lm

    @property
    def device(self):
        return self.aux.tok.device

    @property
    def max_len(self):
        return self.aux.pos.shape[0]

    def _tokens(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(x), dtype=torch.long,
                               device=self.device)

    def _loss(self, x, y):
        """The training loss of token batch x [B, T] against targets y."""
        h = embed_fn(self.aux, x)
        for p in self.blocks:
            h = self.block_fn(p, h)
        return lm_loss(self.aux, h, y)

    def fit_batch(self, x, y):
        """One SGD-with-momentum step on tokens x [B, T] with targets y
        [B, T]; returns the loss before the step. Velocities start at zero
        in the parameter dtype, as the JAX package's `zeros_like`."""
        params = list(self.parameters())
        if self._vel is None:
            self._vel = [torch.zeros_like(p) for p in params]
        loss = self._loss(self._tokens(x), self._tokens(y))
        grads = torch.autograd.grad(loss, params)
        sgd_momentum_update(params, self._vel, grads, self.lr, self.mu)
        return float(loss.detach())

    @torch.inference_mode()
    def logits(self, x):
        """[B, T] tokens -> [B, T, V] logits in the model dtype (the full
        causal forward; with attention="flash", one kernel launch per
        layer)."""
        h = embed_fn(self.aux, self._tokens(x))
        for p in self.blocks:
            h = self.block_fn(p, h)
        return logits_fn(self.aux, h)

    forward = logits

    def _decode_step(self, cache, pos, tokens):
        """One token per row through every block's KV-cache decode:
        tokens [B] at position `pos` -> logits [B, V]; cache updated in
        place."""
        x = self.aux.tok[tokens] + self.aux.pos[pos]
        for p, c in zip(self.blocks, cache):
            x, _ = self._block_decode(p, x, c, pos)
        return logits_fn(self.aux, x)

    def _check_cache_room(self, n_prompt, n_new):
        if n_prompt + n_new > self.max_len:
            raise ValueError(
                f"prompt+new tokens ({n_prompt}+{n_new}) exceed max_len "
                f"{self.max_len} (the KV cache has no sliding window)")

    @torch.inference_mode()
    def generate(self, prompt, max_new_tokens=32, temperature=0.0, seed=0,
                 use_cache=False, draft=None):
        """Autoregressive continuation of `prompt` (token ids); returns the
        list prompt + new tokens. temperature 0 = greedy argmax on f32
        logits; > 0 = sampled on the host with np.random.default_rng(seed),
        as the JAX package does.

        use_cache=False re-encodes the context (at most max_len tokens) for
        every new token: the full causal forward, through the flash kernel
        when attention="flash". use_cache=True feeds the prompt, then each
        new token, through the single-token KV-cache decode step."""
        if draft is not None:
            raise NotImplementedError(f"speculative decoding (draft=) "
                                      f"{_NOT_PORTED}")
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        if not toks:
            raise ValueError("prompt must contain at least one token")
        rng = np.random.default_rng(seed)
        n_new = int(max_new_tokens)

        def pick(logit):
            logit = logit.float().cpu().numpy()
            if temperature <= 0.0:
                return int(logit.argmax())
            p = np.exp((logit - logit.max()) / temperature)
            return int(rng.choice(len(p), p=p / p.sum()))

        if not use_cache:
            for _ in range(n_new):
                ctx = toks[-self.max_len:]
                toks.append(pick(self.logits([ctx])[0, -1]))
            return toks

        self._check_cache_room(len(toks), n_new)
        d_model = self.aux.tok.shape[1]
        cache = init_kv_cache(len(self.blocks), 1, self.max_len, d_model,
                              self.n_heads, self.aux.tok.dtype, self.device)
        one = lambda t: torch.tensor([t], device=self.device)
        logit = None
        for pos, t in enumerate(toks):
            logit = self._decode_step(cache, pos, one(t))[0]
        for i in range(n_new):
            toks.append(pick(logit))
            if i < n_new - 1:    # no decode needed after the last token
                logit = self._decode_step(cache, len(toks) - 1,
                                          one(toks[-1]))[0]
        return toks

    @torch.inference_mode()
    def generate_batch(self, prompts, max_new_tokens, temperature=0.0,
                       seed=0, draft=None):
        """Batched KV-cache decode of equal-length `prompts` [B, P]: one
        parallel prefill fills every layer's cache, then one decode step per
        new token. temperature <= 0 = greedy (argmax on f32 logits);
        > 0 = sampled on the device from a torch.Generator seeded with
        `seed` (deterministic per seed; not the JAX package's draws).
        Returns a numpy array [B, P + max_new_tokens]."""
        if draft is not None:
            raise NotImplementedError(f"speculative decoding (draft=) "
                                      f"{_NOT_PORTED}")
        prompts = self._tokens(prompts)
        B, P = prompts.shape
        n_new = int(max_new_tokens)
        if n_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n_new}")
        self._check_cache_room(P, n_new)
        sampled = float(temperature) > 0.0
        temp = max(float(temperature), 1e-6)
        gen = (torch.Generator(device=self.device).manual_seed(int(seed))
               if sampled else None)

        def pick(logit):
            if not sampled:
                return logit.argmax(-1)
            probs = torch.softmax(logit / temp, -1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        h, cache = prefill_forward(self.aux, self.blocks, prompts,
                                   self.n_heads, self.max_len)
        logit = logits_fn(self.aux, h[:, -1]).float()
        new = []
        for i in range(n_new):
            new.append(pick(logit))
            if i < n_new - 1:
                logit = self._decode_step(cache, P + i, new[-1]).float()
        out = torch.cat([prompts, torch.stack(new, 1)], 1)
        return out.cpu().numpy()
