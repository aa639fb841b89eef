"""Decoder-only transformer LM: port of
deeplearning4j_tpu/models/zoo/transformer.py (training with `fit_batch`,
inference with `logits`, `generate`, `generate_batch`, and the serving
programs that `serving/decode.py`'s ContinuousDecodeServer runs).

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

The serving programs (fixed-slot and paged decode, prefill and install,
chunked prefill, block copy and extract, fused K-step windows, the K-wide
speculative verify in both layouts) are plain functions on
tensors, written with torch indexing as the reference writes them with
XLA gather/scatter; no kernel of `ops/` runs in them. torch has no
drop-mode scatter, so every serving cache carries one spare row past its
end that no read covers: a write the reference drops (an inactive slot,
a row past the cache or outside a write window) is sent there instead.
Live rows never share an index within one write, so `index_put_` stays
deterministic on CUDA; duplicate writes to the spare row race harmlessly.
Nothing in a decode or window program waits on the host (argmax runs on
the device), so a window can be captured as one CUDA graph.

Speculative decoding (`generate(draft=)`, `generate_batch(draft=)`, the
decode server's `speculate=`) is greedy only, as the reference's: a draft
source (`serving.speculate`) proposes K-1 tokens and one K-wide verify
call accepts the longest matching prefix plus one bonus token.
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


def init_tp_block(generator, d_model, n_heads, d_ff, dtype=torch.float32,
                  device=None):
    """Block parameters in the tensor-parallel layout: the attention
    projections per head, wqkv [H, D, 3*hd] and wo [H, hd, D], so the head
    dimension splits over "model" (the Megatron split); the MLP splits w1's
    columns, b1 and w2's rows. The numerics are `init_block`'s; only the
    storage axes differ. Drawn from `generator` (a CPU generator)."""
    device = resolve_device(device)
    hd = d_model // n_heads
    s_attn = 1.0 / math.sqrt(d_model)
    s_ff = 1.0 / math.sqrt(d_ff)
    normal = lambda shape, std: _normal(generator, shape, std, dtype, device)
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return Block(
        _fresh_layer_norm(d_model, dtype, device),
        Attention(normal((n_heads, d_model, 3 * hd), s_attn),
                  normal((n_heads, hd, d_model), s_attn)),
        _fresh_layer_norm(d_model, dtype, device),
        MLP(normal((d_model, d_ff), s_attn), zeros(d_ff),
            normal((d_ff, d_model), s_ff), zeros(d_model)))


def tp_block_specs(pipe_axis="pipe", model_axis="model"):
    """The Megatron layout of STACKED `init_tp_block` parameters (a leading
    stage axis over `pipe_axis`), one axis name (or None) per dimension,
    by the parameter's dotted name: the attention heads and the MLP hidden
    dimension over `model_axis`, LayerNorms and b2 whole. What
    `parallel.pipeline.PipelineParallel(param_specs=...)` slices by."""
    return {"ln1.g": (pipe_axis,), "ln1.b": (pipe_axis,),
            "attn.wqkv": (pipe_axis, model_axis),
            "attn.wo": (pipe_axis, model_axis),
            "ln2.g": (pipe_axis,), "ln2.b": (pipe_axis,),
            "mlp.w1": (pipe_axis, None, model_axis),
            "mlp.b1": (pipe_axis, model_axis),
            "mlp.w2": (pipe_axis, model_axis, None),
            "mlp.b2": (pipe_axis,)}


def tp_block_from_jax(p, model_index=0, n_model=1, dtype=None, device=None):
    """The weight bridge for one tensor-parallel block: the JAX package's
    full `init_tp_block` tree (numpy arrays) -> the Block of model rank
    `model_index` of `n_model`: heads [m*Hl, (m+1)*Hl) of wqkv and wo, the
    same slice of w1's columns, b1 and w2's rows; LayerNorms and b2
    whole."""
    device = resolve_device(device)
    specs = tp_block_specs(None, "model")

    def t(name, a):
        a = _from_numpy(a, dtype, device)
        for dim, axis in enumerate(specs[name][1:]):
            if axis is not None:
                c = a.shape[dim] // n_model
                a = a.narrow(dim, model_index * c, c).contiguous()
        return a

    ln = lambda n: LayerNorm(t(f"{n}.g", p[n]["g"]), t(f"{n}.b", p[n]["b"]))
    a, m = p["attn"], p["mlp"]
    return Block(ln("ln1"), Attention(t("attn.wqkv", a["wqkv"]),
                                      t("attn.wo", a["wo"])),
                 ln("ln2"), MLP(t("mlp.w1", m["w1"]), t("mlp.b1", m["b1"]),
                                t("mlp.w2", m["w2"]), t("mlp.b2", m["b2"])))


def tp_layout(named, n_heads):
    """{dotted name: tensor} of a dense-layout block (`init_block`'s, or
    its gradients) -> the same in `init_tp_block`'s layout: wqkv [D, 3D]
    -> [H, D, 3*hd] (each head's q, k, v columns), wo [D, D] -> [H, hd,
    D]; the rest as it is. The same function, other storage axes."""
    out = dict(named)
    wqkv, wo = named["attn.wqkv"], named["attn.wo"]
    d = wo.shape[0]
    hd = d // n_heads
    per = lambda a: a.reshape(d, n_heads, hd).transpose(0, 1)  # [H, D, hd]
    q, k, v = wqkv.split(d, -1)
    out["attn.wqkv"] = torch.cat([per(q), per(k), per(v)], -1).contiguous()
    out["attn.wo"] = wo.reshape(n_heads, hd, d).contiguous()
    return out


def tp_block_from_block(p, n_heads):
    """A dense Block -> a whole Block in the tensor-parallel layout (copies;
    `PipelineParallel(param_specs=tp_block_specs())` slices it)."""
    t = tp_layout({n: a.detach() for n, a in p.named_parameters()}, n_heads)
    ln = lambda n: LayerNorm(t[f"{n}.g"].clone(), t[f"{n}.b"].clone())
    return Block(ln("ln1"), Attention(t["attn.wqkv"], t["attn.wo"]),
                 ln("ln2"), MLP(t["mlp.w1"].clone(), t["mlp.b1"].clone(),
                                t["mlp.w2"].clone(), t["mlp.b2"].clone()))


def make_tp_block_fn(n_heads_local, model_axis="model", mesh=None):
    """The tensor-parallel block, run by every rank of `mesh`'s
    `model_axis` on its head group and MLP hidden slice (a Block from
    `tp_block_from_jax` or sliced by `tp_block_specs`): two all-reduces a
    block, after the attention output projection and after the MLP
    down-projection (the Megatron recipe). Each all-reduce is paired with
    its conjugate where the replicated activation enters the split
    matmuls (`sharding.copy_to` after each LayerNorm), so every rank's
    gradients are the true ones. mesh=None: one rank, no collective.

    The numerics are the reference's: dense scores masked with the dtype's
    finfo.min, softmax in f32 cast to x's dtype, tanh GeLU.
    n_heads_local: heads per rank, asserted against the local slice."""
    from ...parallel.sharding import copy_to, reduce_from
    group = None if mesh is None else mesh.axis_group(model_axis)

    def block_fn(p, x):
        B, T, D = x.shape
        assert p.attn.wqkv.shape[0] == n_heads_local, \
            (tuple(p.attn.wqkv.shape), n_heads_local)
        hd = p.attn.wqkv.shape[2] // 3
        h = copy_to(_layer_norm(x, p.ln1.g, p.ln1.b), group)
        qkv = torch.einsum("btd,hdk->bthk", h, p.attn.wqkv)
        q, k, v = (a.transpose(1, 2) for a in qkv.split(hd, -1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
        att = torch.softmax(scores.float(), -1).to(x.dtype)
        out = (att @ v).transpose(1, 2)                    # [B, T, Hl, hd]
        o_part = torch.einsum("bthk,hkd->btd", out, p.attn.wo)
        x = x + reduce_from(o_part, group)
        h = copy_to(_layer_norm(x, p.ln2.g, p.ln2.b), group)
        m = F.gelu(h @ p.mlp.w1 + p.mlp.b1, approximate="tanh")
        return x + reduce_from(m @ p.mlp.w2, group) + p.mlp.b2

    return block_fn


class MoEBlock(nn.Module):
    """One mixture-of-experts block's parameters: ln1, attn, ln2, moe."""

    def __init__(self, ln1, attn, ln2, moe):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.moe = ln1, attn, ln2, moe


def make_moe_block_fn(n_heads, moe_apply):
    """A block whose MLP is a mixture of experts: dense causal attention
    as `make_block_fn`, the FFN replaced by `moe_apply(p.moe, tokens)`
    (`parallel.moe`'s dense or expert-parallel apply). Returns (y,
    aux_loss) so the trainer can add the load-balance term."""

    def block_fn(p, x):
        B, T, D = x.shape
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        x = x + causal_attention(h, p.attn.wqkv, p.attn.wo, n_heads)
        h = _layer_norm(x, p.ln2.g, p.ln2.b)
        y, aux = moe_apply(p.moe, h.reshape(B * T, D))
        return x + y.reshape(B, T, D), aux

    return block_fn


def init_moe_block(generator, d_model, n_heads, n_experts, d_ff,
                   dtype=torch.float32, device=None):
    """A MoEBlock: attention and LayerNorms as `init_block`, then the
    experts from `parallel.moe.init_moe`, all from `generator`."""
    from ...parallel.moe import init_moe
    b = init_block(generator, d_model, n_heads, d_ff, dtype, device)
    return MoEBlock(b.ln1, b.attn, b.ln2,
                    init_moe(generator, d_model, n_experts, d_ff, dtype,
                             resolve_device(device)))


def moe_block_from_jax(p, dtype=None, device=None):
    """The weight bridge for `init_moe_block`'s tree (numpy arrays)."""
    from ...parallel.moe import MoE
    device = resolve_device(device)
    t = lambda a: _from_numpy(a, dtype, device)
    ln = lambda n: LayerNorm(t(p[n]["g"]), t(p[n]["b"]))
    return MoEBlock(ln("ln1"), Attention(t(p["attn"]["wqkv"]),
                                         t(p["attn"]["wo"])),
                    ln("ln2"), MoE(**{k: t(v) for k, v in p["moe"].items()}))


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


# -- serving programs (serving/decode.py) -----------------------------------
#
# Shapes follow the reference; integer tensors (positions, tokens, tables,
# row counts) are int64, the index type of torch. A fixed-slot serving cache
# is [S + 1, L, H, hd] per layer (`init_slot_kv_cache`): slot S is the spare
# that dropped writes land in. A paged arena is [n_rows + 1, H, hd]
# (`init_paged_kv_cache`): row n_rows is the spare. Reads never cover the
# spare, so the attended values, and the reductions over them, are the
# reference's.


def _embed_at(aux, tok, pos):
    """tok/pos ids -> embeddings, ids clamped into range as XLA's gathers
    clamp them (a stale slot's ids are computed over, never consumed)."""
    max_len = aux.pos.shape[0]
    tok = tok.clamp(0, aux.tok.shape[0] - 1)
    return aux.tok[tok] + aux.pos[pos.clamp(0, max_len - 1)]


def _attend(q, k_rows, v_rows, keep, dtype):
    """The decode attention over gathered rows: q [S, (K,) H, hd], rows
    [S, L, H, hd], keep [S, 1, (K,) L] bool -> [S, (K,) H, hd]. The same
    einsum, mask and f32 softmax as `make_decode_block_fn`."""
    hd = q.shape[-1]
    if q.dim() == 3:
        scores = torch.einsum("shd,slhd->shl", q, k_rows) / math.sqrt(hd)
    else:
        scores = torch.einsum("skhd,slhd->shkl", q, k_rows) / math.sqrt(hd)
    scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), -1).to(dtype)
    if q.dim() == 3:
        return torch.einsum("shl,slhd->shd", att, v_rows)
    return torch.einsum("shkl,slhd->skhd", att, v_rows)


def gated_cache_rows(cache, idx, k_new, v_new):
    """The ONE cache row write shared by every serving program, in place:
    cache {"k", "v"}; idx an index tuple addressing whole [..., H, hd]
    rows; k_new / v_new the new rows, shaped like the selection.

    The indices encode the gating. The reference sends a suppressed row
    out of range, where its drop-mode scatter discards it (and gates the
    fixed-slot writes by writing an inactive row's old value back); here
    every suppressed row goes to the spare row past the cache's end (slot
    S of a fixed cache, row n_rows of a paged arena), which no read
    covers. Index gating is what the paged programs need anyway: a free
    slot's stale block table may alias a live slot's block, and a
    write-back would race the live row."""
    for name, new in (("k", k_new), ("v", v_new)):
        cache[name].index_put_(idx, new.to(cache[name].dtype))
    return cache


def _with_spare_slot(cache):
    """A [B, L, H, hd] cache as a fixed-slot serving cache [B + 1, ...]
    (a zero spare slot appended)."""
    return [{n: torch.cat([c[n], torch.zeros_like(c[n][:1])])
             for n in ("k", "v")} for c in cache]


def init_slot_kv_cache(n_layers, slots, max_len, d_model, n_heads,
                       dtype=torch.float32, device=None):
    """The fixed-slot serving cache: per layer {k, v: [slots + 1, max_len,
    H, hd]}, slot `slots` the spare that dropped writes land in."""
    return init_kv_cache(n_layers, int(slots) + 1, max_len, d_model,
                         n_heads, dtype, device)


def make_slot_decode_block_fn(n_heads):
    """`make_decode_block_fn` for a FIXED-SLOT serving batch:

    block_decode(p, x [S, D], cache {k,v: [S + 1, L, H, hd]}, pos [S],
                 active [S] bool) -> (y [S, D], cache)

    Every slot's row is computed; only active slots write their k/v row
    at `pos` (an inactive slot's write goes to the spare slot S), so an
    inactive slot's cache stays bit-identical while neighbours decode.
    Each row depends only on its own x/cache/pos rows: a request's token
    stream does not depend on who shares the batch."""

    def block_decode(p, x, cache, pos, active):
        S, D = x.shape
        H = n_heads
        hd = D // H
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        q, k, v = (h @ p.attn.wqkv).split(D, -1)
        L = cache["k"].shape[1]
        rows = torch.where(active, torch.arange(S, device=x.device), S)
        gated_cache_rows(cache, (rows, pos.clamp(0, L - 1)),
                         k.reshape(S, H, hd), v.reshape(S, H, hd))
        keep = (torch.arange(L, device=x.device)[None, None, :]
                <= pos[:, None, None])
        out = _attend(q.reshape(S, H, hd), cache["k"][:S], cache["v"][:S],
                      keep, x.dtype).reshape(S, D)
        return _mlp_residual(p, x + out @ p.attn.wo), cache

    return block_decode


def _decode_model(block_decode, aux, blocks, tok, pos, *args):
    """Embed, every block, f32 logits and the device-side argmax."""
    x = _embed_at(aux, tok, pos)
    for p, c in zip(blocks, args[0]):
        x, _ = block_decode(p, x, c, *args[1:])
    logits = logits_fn(aux, x).float()
    return logits.argmax(-1), logits


def make_slot_decode_fn(n_heads):
    """One ITERATION of continuous-batching decode, the whole model:

    step(aux, blocks, cache, pos [S], tok [S], active [S])
      -> (next_tok [S], logits [S, V] f32, cache, new pos)

    Greedy argmax on the device over f32 logits; the cache is updated in
    place; pos advances by `active`."""
    block_decode = make_slot_decode_block_fn(n_heads)

    @torch.no_grad()
    def step(aux, blocks, cache, pos, tok, active):
        nxt, logits = _decode_model(block_decode, aux, blocks, tok, pos,
                                    cache, pos, active)
        return nxt, logits, cache, pos + active.to(pos.dtype)

    return step


def make_slot_verify_block_fn(n_heads):
    """`make_slot_decode_block_fn` widened to K query positions per slot,
    the fixed layout's K-wide block (chunked prefill's chunk block):

    block_verify(p, x [S, K, D], cache {k,v: [S + 1, L, H, hd]}, pos [S],
                 active [S] bool) -> (y [S, K, D], cache)

    Slot s's K inputs land at rows pos[s]..pos[s]+K-1, all written before
    attention; query i attends to rows <= pos[s]+i. Inactive slots and
    rows past the cache's end write to the spare slot."""

    def block_verify(p, x, cache, pos, active):
        S, K, D = x.shape
        H = n_heads
        hd = D // H
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        q, k, v = (h @ p.attn.wqkv).split(D, -1)
        L = cache["k"].shape[1]
        dev = x.device
        pcols = pos[:, None] + torch.arange(K, device=dev)[None, :]
        ok = active[:, None] & (pcols < L)
        rows = torch.where(ok, torch.arange(S, device=dev)[:, None], S)
        gated_cache_rows(cache, (rows, pcols.clamp(0, L - 1)),
                         k.reshape(S, K, H, hd), v.reshape(S, K, H, hd))
        keep = (torch.arange(L, device=dev)[None, None, None, :]
                <= pcols[:, None, :, None])
        out = _attend(q.reshape(S, K, H, hd), cache["k"][:S],
                      cache["v"][:S], keep, x.dtype).reshape(S, K, D)
        return _mlp_residual(p, x + out @ p.attn.wo), cache

    return block_verify


def _verify_model(block_verify, k, aux, blocks, cache, pos, toks, active,
                  *args):
    """The K-wide verify over the whole model: (nxt [S, K], n_acc [S],
    logits [S, K, V] f32, cache, new pos). n_acc[s] is the length of the
    longest prefix with nxt[s, i] == toks[s, i + 1]; pos advances by
    n_acc + 1 on active slots."""
    pcols = pos[:, None] + torch.arange(k, device=pos.device)[None, :]
    x = _embed_at(aux, toks, pcols)
    for p, c in zip(blocks, cache):
        x, _ = block_verify(p, x, c, *args)
    logits = logits_fn(aux, x).float()
    nxt = logits.argmax(-1)
    match = (nxt[:, :k - 1] == toks[:, 1:]).to(torch.int64)
    n_acc = match.cumprod(1).sum(1)
    return (nxt, n_acc, logits, cache,
            pos + torch.where(active, n_acc + 1, 0).to(pos.dtype))


def _verify_width(k):
    k = int(k)
    if k < 1:
        raise ValueError(f"speculative width k must be >= 1, got {k}")
    return k


def make_slot_verify_fn(n_heads, k):
    """One SPECULATIVE iteration of fixed-slot decode, up to K tokens per
    call:

    verify(aux, blocks, cache, pos [S], toks [S, K], active [S])
      -> (nxt [S, K], n_acc [S], logits [S, K, V] f32, cache, new pos)

    toks[s, 0] is slot s's last accepted token, toks[s, 1:] its K-1 draft
    tokens (any values: a bad draft costs acceptance, never correctness).
    The K rows are written at pos[s]..pos[s]+K-1 before attention, and
    nxt[s, i] is the greedy argmax after the stream prefix ..toks[s, i].
    The caller consumes nxt[s, :n_acc[s] + 1], so the emitted stream is
    this program's own argmax chain. Rejected-suffix rows are dead rows
    the next call overwrites before any query attends to them. k=1 is
    plain decode through the verify program."""
    block_verify = make_slot_verify_block_fn(n_heads)
    k = _verify_width(k)

    @torch.no_grad()
    def verify(aux, blocks, cache, pos, toks, active):
        return _verify_model(block_verify, k, aux, blocks, cache, pos,
                             toks, active, pos, active)

    return verify


def make_prefill_fn(n_heads, cache_len):
    """Serving prefill for ONE request, prompt right-padded to a bucket:

    prefill(aux, blocks, prompt [1, Pb], length) -> (logits [1, V] f32 at
    the last REAL token, cache rows [{k, v: [1, cache_len, H, hd]}])

    The padding tail's k/v rows are installed too, and overwritten by
    decode before any query attends to them."""

    @torch.no_grad()
    def prefill(aux, blocks, prompt, length):
        h, cache = prefill_forward(aux, blocks, prompt, n_heads, cache_len)
        return logits_fn(aux, h[:, int(length) - 1]).float(), cache

    return prefill


def init_paged_kv_cache(n_layers, n_blocks, block_size, d_model, n_heads,
                        dtype=torch.float32, device=None):
    """PAGED KV arena: per layer {k, v: [n_blocks * block_size + 1, H,
    hd]}, flat row-major (physical row = block * block_size + offset),
    the last row the spare that dropped writes land in. Which stream owns
    which block is host state (`serving.kvpool.BlockPool`)."""
    device = resolve_device(device)
    hd = d_model // n_heads
    rows = int(n_blocks) * int(block_size) + 1
    z = lambda: torch.zeros(rows, n_heads, hd, dtype=dtype, device=device)
    return [{"k": z(), "v": z()} for _ in range(n_layers)]


def _window_rows(btab, bs):
    """[S, NB] block table -> [S, NB * bs] physical rows of each slot's
    logical window."""
    S, NB = btab.shape
    return (btab[:, :, None] * bs
            + torch.arange(bs, device=btab.device)).reshape(S, NB * bs)


def _gather_rows(buf, flat):
    """arena [n_rows + 1, H, hd] at rows [S, L] -> [S, L, H, hd]."""
    return buf.index_select(0, flat.reshape(-1)).view(
        *flat.shape, *buf.shape[1:])


def make_paged_decode_block_fn(n_heads, block_size):
    """`make_slot_decode_block_fn` with the cache reached through a BLOCK
    TABLE (vLLM PagedAttention):

    block_decode(p, x [S, D], cache {k,v: [n_rows + 1, H, hd]},
                 btab [S, NB], pos [S], active [S] bool) -> (y, cache)

    Logical row l of slot s lives at physical row btab[s, l // bs] * bs +
    l % bs. The write lands at the slot's frontier; an inactive slot's
    goes to the spare row (gating by index: a free slot's stale table may
    alias a live block). Attention gathers the slot's whole logical
    window [S, NB * bs, H, hd] and runs the fixed block's math."""
    bs = int(block_size)

    def block_decode(p, x, cache, btab, pos, active):
        S, D = x.shape
        H = n_heads
        hd = D // H
        NB = btab.shape[1]
        L = NB * bs
        n_rows = cache["k"].shape[0] - 1
        dev = x.device
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        q, k, v = (h @ p.attn.wqkv).split(D, -1)
        blk = btab[torch.arange(S, device=dev), (pos // bs).clamp(0, NB - 1)]
        widx = torch.where(active, blk * bs + pos % bs, n_rows)
        gated_cache_rows(cache, (widx,), k.reshape(S, H, hd),
                         v.reshape(S, H, hd))
        flat = _window_rows(btab, bs)
        keep = (torch.arange(L, device=dev)[None, None, :]
                <= pos[:, None, None])
        out = _attend(q.reshape(S, H, hd), _gather_rows(cache["k"], flat),
                      _gather_rows(cache["v"], flat), keep,
                      x.dtype).reshape(S, D)
        return _mlp_residual(p, x + out @ p.attn.wo), cache

    return block_decode


def make_paged_decode_fn(n_heads, block_size):
    """One ITERATION of paged continuous-batching decode:

    step(aux, blocks, cache, btabs [S, NB], pos [S], tok [S], active [S])
      -> (next_tok [S], logits [S, V] f32, cache, new pos)

    `make_slot_decode_fn`'s contract over arena + block tables."""
    block_decode = make_paged_decode_block_fn(n_heads, block_size)

    @torch.no_grad()
    def step(aux, blocks, cache, btabs, pos, tok, active):
        nxt, logits = _decode_model(block_decode, aux, blocks, tok, pos,
                                    cache, btabs, pos, active)
        return nxt, logits, cache, pos + active.to(pos.dtype)

    return step


def _window_floor(k):
    k = int(k)
    if k < 2:
        raise ValueError(f"fused window k must be >= 2 (k=1 is the "
                         f"plain decode program), got {k}")
    return k


def make_fused_decode_fn(n_heads, k):
    """K iterations of fixed-slot decode in one call, the body
    `make_slot_decode_fn`'s step:

    window(aux, blocks, cache, pos [S], tok [S], active [S], steps [S])
      -> (toks [K, S], cache, new pos)

    Step i gates each slot on `active & (i < steps)`: a slot whose budget
    is spent freezes like an inactive one. toks[i, s] is garbage for
    i >= steps[s]. Nothing waits on the host, so the server captures the
    window as one CUDA graph (on the CPU it runs eagerly)."""
    block_decode = make_slot_decode_block_fn(n_heads)
    k = _window_floor(k)

    @torch.no_grad()
    def window(aux, blocks, cache, pos, tok, active, steps):
        toks = []
        for i in range(k):
            act = active & (steps > i)
            nxt, _ = _decode_model(block_decode, aux, blocks, tok, pos,
                                   cache, pos, act)
            tok = torch.where(act, nxt, tok)
            pos = pos + act.to(pos.dtype)
            toks.append(nxt)
        return torch.stack(toks), cache, pos

    return window


def make_paged_fused_decode_fn(n_heads, block_size, k):
    """`make_fused_decode_fn` through the block table:

    window(aux, blocks, cache, btabs [S, NB], pos [S], tok [S],
           active [S], steps [S], wto [S]) -> (toks [K, S], cache, pos)

    The table is static across the window; step gating adds `pos < wto`
    (the slot's reserved rows), so no write crosses an unreserved block."""
    block_decode = make_paged_decode_block_fn(n_heads, block_size)
    k = _window_floor(k)

    @torch.no_grad()
    def window(aux, blocks, cache, btabs, pos, tok, active, steps, wto):
        toks = []
        for i in range(k):
            act = active & (steps > i) & (pos < wto)
            nxt, _ = _decode_model(block_decode, aux, blocks, tok, pos,
                                   cache, btabs, pos, act)
            tok = torch.where(act, nxt, tok)
            pos = pos + act.to(pos.dtype)
            toks.append(nxt)
        return torch.stack(toks), cache, pos

    return window


def make_paged_prefill_fn(n_heads):
    """Serving prefill over the PAGED cache, the compute half:

    prefill(aux, blocks, prompt [1, Pb], length)
      -> (logits [1, V] f32 at the last REAL token,
          panels [(kp, vp)] per layer, each [1, Pb, H, hd])

    It neither reads nor writes the arena, so a failed prefill fails only
    its request; `make_paged_install_fn` writes the panels."""

    @torch.no_grad()
    def prefill(aux, blocks, prompt, length):
        h, panels = prefill_panels(aux, blocks, prompt, n_heads)
        return logits_fn(aux, h[:, int(length) - 1]).float(), panels

    return prefill


def make_paged_install_fn(block_size):
    """Install half of the paged prefill, in place:

    install(cache, panels, btab [NB], length, shared_len) -> cache

    Rows >= length (bucket padding) and rows < shared_len (a prefix-cache
    hit: resident rows with the same bits) go to the spare row."""
    bs = int(block_size)

    @torch.no_grad()
    def install(cache, panels, btab, length, shared_len):
        P = panels[0][0].shape[1]
        NB = btab.shape[0]
        n_rows = cache[0]["k"].shape[0] - 1
        r = torch.arange(P, device=btab.device)
        pr = btab[(r // bs).clamp(0, NB - 1)] * bs + r % bs
        write = (r >= int(shared_len)) & (r < int(length))
        widx = torch.where(write, pr, n_rows)
        for c, (kp, vp) in zip(cache, panels):
            gated_cache_rows(c, (widx,), kp[0], vp[0])
        return cache

    return install


def make_paged_verify_block_fn(n_heads, block_size):
    """`make_paged_decode_block_fn` widened to K query positions per slot,
    the paged layout's K-wide block (chunked prefill's chunk block):

    block_verify(p, x [S, K, D], cache {k,v: [n_rows + 1, H, hd]},
                 btab [S, NB], pos [S], active [S] bool, wfrom [S],
                 wto [S]) -> (y [S, K, D], cache)

    Slot s's K inputs sit at logical rows pos[s]..pos[s]+K-1, written
    before attention. A row writes only when its slot is active and its
    logical row lies in [wfrom[s], wto[s]) and inside the table: rows
    below wfrom are a resident prefix (attended, never rewritten), rows
    at or past wto would resolve through a zeroed table entry into block
    0 of another stream. The others go to the spare row."""
    bs = int(block_size)

    def block_verify(p, x, cache, btab, pos, active, wfrom, wto):
        S, K, D = x.shape
        H = n_heads
        hd = D // H
        NB = btab.shape[1]
        L = NB * bs
        n_rows = cache["k"].shape[0] - 1
        dev = x.device
        h = _layer_norm(x, p.ln1.g, p.ln1.b)
        q, k, v = (h @ p.attn.wqkv).split(D, -1)
        lrows = pos[:, None] + torch.arange(K, device=dev)[None, :]
        blk = btab[torch.arange(S, device=dev)[:, None],
                   (lrows // bs).clamp(0, NB - 1)]
        ok = (active[:, None] & (lrows >= wfrom[:, None])
              & (lrows < wto[:, None]) & (lrows < L))
        widx = torch.where(ok, blk * bs + lrows % bs, n_rows)
        gated_cache_rows(cache, (widx,), k.reshape(S, K, H, hd),
                         v.reshape(S, K, H, hd))
        flat = _window_rows(btab, bs)
        keep = (torch.arange(L, device=dev)[None, None, None, :]
                <= lrows[:, None, :, None])
        out = _attend(q.reshape(S, K, H, hd),
                      _gather_rows(cache["k"], flat),
                      _gather_rows(cache["v"], flat), keep,
                      x.dtype).reshape(S, K, D)
        return _mlp_residual(p, x + out @ p.attn.wo), cache

    return block_verify


def make_paged_verify_fn(n_heads, k, block_size):
    """`make_slot_verify_fn` through the block table:

    verify(aux, blocks, cache, btabs [S, NB], pos [S], toks [S, K],
           active [S], wto [S])
      -> (nxt [S, K], n_acc [S], logits [S, K, V] f32, cache, new pos)

    The K rows write at the table-mapped frontier rows under the paged
    chunk program's [wfrom, wto) gate with wfrom = pos (every verify row
    is new) and wto = the slot's reserved rows (`BlockPool.
    writable_rows`): an overhang past the reservation goes to the spare
    row instead of resolving through a zeroed table entry into another
    stream's block. The caller's cap on consumed tokens keeps every
    consumed query inside the reservation. A CoW-shared partial block
    must be materialized before the first verify, as before a 1-wide
    append."""
    block_verify = make_paged_verify_block_fn(n_heads, block_size)
    k = _verify_width(k)

    @torch.no_grad()
    def verify(aux, blocks, cache, btabs, pos, toks, active, wto):
        return _verify_model(block_verify, k, aux, blocks, cache, pos,
                             toks, active, btabs, pos, active, pos, wto)

    return verify


def make_block_extract_fn(block_size):
    """Extract half of durable KV state (`serving/kvstate.py`), the
    inverse of `make_paged_install_fn`: a pure gather of a block table's
    rows out of the arena.

    extract(cache, btab [NB]) -> [(k, v)] per layer, each [NB * bs, H, hd]

    Row r is LOGICAL row r of the table's request. Rows at or past the
    request's frontier are dead or resolve through zeroed table entries
    into block 0: the caller keeps only [:pos]. The spare row is never
    read."""
    bs = int(block_size)

    @torch.no_grad()
    def extract(cache, btab):
        flat = (btab[:, None] * bs
                + torch.arange(bs, device=btab.device)[None, :]).reshape(-1)
        return [(c["k"].index_select(0, flat), c["v"].index_select(0, flat))
                for c in cache]

    return extract


def make_paged_chunk_block_fn(n_heads, block_size):
    """Chunked prefill's paged block: the K-wide paged block under its
    chunk-role name."""
    return make_paged_verify_block_fn(n_heads, block_size)


def make_chunked_prefill_fn(n_heads, chunk, block_size=None):
    """CHUNKED prefill: C prompt rows of each prefilling slot per call,
    attending into the rows earlier chunks installed.

    block_size=None, the FIXED-SLOT layout:
      step(aux, blocks, cache, pos [S], toks [S, C], nrows [S],
           active [S]) -> (nxt [S, C], cache, new pos)
    an int, the PAGED layout:
      step(aux, blocks, cache, btabs [S, NB], pos [S], toks [S, C],
           nrows [S], active [S], wfrom [S], wto [S])
        -> (nxt [S, C], cache, new pos)

    The K-wide block with prefill semantics: pos advances by nrows (the
    real rows of this chunk); the host reads nxt[s, nrows - 1] of the last
    chunk, the request's first generated token. C >= 2, as the reference's
    floor (a 1-row product may take another accumulation path)."""
    C = int(chunk)
    if C < 2:
        raise ValueError(f"chunk size must be >= 2 (a 1-row product takes "
                         f"the gemv path), got {chunk}")
    block = (make_slot_verify_block_fn(n_heads) if block_size is None
             else make_paged_chunk_block_fn(n_heads, block_size))

    def run(aux, blocks, cache, pos, toks, nrows, active, *args):
        pcols = pos[:, None] + torch.arange(C, device=pos.device)[None, :]
        x = _embed_at(aux, toks, pcols)
        for p, c in zip(blocks, cache):
            x, _ = block(p, x, c, *args)
        nxt = logits_fn(aux, x).float().argmax(-1)
        return nxt, cache, pos + torch.where(active, nrows, 0)

    if block_size is None:
        @torch.no_grad()
        def step(aux, blocks, cache, pos, toks, nrows, active):
            return run(aux, blocks, cache, pos, toks, nrows, active,
                       pos, active)
        return step

    @torch.no_grad()
    def step(aux, blocks, cache, btabs, pos, toks, nrows, active, wfrom,
             wto):
        return run(aux, blocks, cache, pos, toks, nrows, active, btabs,
                   pos, active, wfrom, wto)

    return step


def make_block_copy_fn(block_size):
    """Copy-on-write worker: copy(cache, src, dst) copies physical block
    src's rows to block dst in every layer, in place (src, dst ints)."""
    bs = int(block_size)

    @torch.no_grad()
    def copy(cache, src, dst):
        s, d = int(src) * bs, int(dst) * bs
        for c in cache:
            for name in ("k", "v"):
                c[name][d:d + bs].copy_(c[name][s:s + bs])
        return cache

    return copy

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
    return _params_from_tree(aux, blocks,
                             lambda a: _from_numpy(a, dtype, device))


def _ordered(module):
    """`module`'s (dotted name, parameter) sorted by the name's parts."""
    named = [(tuple(n.split(".")), n, t) for n, t in module.named_parameters()]
    return [(n, t) for _, n, t in sorted(named, key=lambda e: e[0])]


def tree_leaves(aux, blocks):
    """The parameters of one version `(aux, blocks)` in the JAX package's
    `tree_leaves((aux, blocks))` order, every dict level in sorted key
    order; each tensor in its own layout, which is the reference's."""
    return [t for m in (aux, *blocks) for _, t in _ordered(m)]


def params_from_leaves(leaves, like):
    """`tree_leaves`' inverse: a new (Aux, [Block]) holding `leaves`
    (tensors, on any device) laid out as the version `like` = (aux,
    blocks), each leaf moved to the device of `like`'s leaf in its place.
    Shapes and dtypes are kept as given (a server's `swap` refuses a
    mismatch); a wrong leaf count raises ValueError."""
    aux, blocks = like
    names = [[n for n, _ in _ordered(m)] for m in (aux, *blocks)]
    olds = tree_leaves(aux, blocks)
    if len(leaves) != len(olds):
        raise ValueError(f"{len(leaves)} leaves for a version of "
                         f"{len(olds)}")
    it = iter(new.to(device=old.device) for new, old in zip(leaves, olds))
    trees = []
    for group in names:
        tree = {}
        for n in group:
            *path, last = n.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = next(it)
        trees.append(tree)
    return _params_from_tree(trees[0], trees[1:], lambda t: t)


def _params_from_tree(aux, blocks, t):
    """Nested dicts of leaves laid out as the JAX package's `(aux, blocks)`
    -> (Aux, [Block]), each leaf through `t`."""
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

    def _spec_verify(self, k):
        """The fixed-slot K-wide verify program, one per width k (shared by
        generate(draft=) and the decode server's `speculate=`)."""
        progs = self.__dict__.setdefault("_spec_verify_cache", {})
        if int(k) not in progs:
            progs[int(k)] = make_slot_verify_fn(self.n_heads, k)
        return progs[int(k)]

    @staticmethod
    def _unwrap_draft(draft, k):
        """A bare DraftSource or a Speculator bundle (it has .draft and
        .k) for `draft=`."""
        if hasattr(draft, "draft") and hasattr(draft, "k"):
            return draft.draft, int(draft.k)
        return draft, int(k)

    def _spec_check(self, n_prompt, n_new, temperature):
        if float(temperature) > 0.0:
            raise ValueError("speculative decoding is greedy-only "
                             "(acceptance is by exact argmax match); got "
                             f"temperature={temperature}")
        if n_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n_new}")
        self._check_cache_room(n_prompt, n_new)

    def _spec_rounds(self, cache, pos, gens, n_new, draft, keys, k):
        """Verify rounds until every row of `gens` (lists of generated
        tokens, each starting with the prefilled first token) holds n_new:
        per round the rows' drafts, one verify call over the slot cache
        (a spare slot past the rows), one host copy of (n_acc, nxt)."""
        B = len(gens)
        verify = self._spec_verify(k)
        dev = self.device
        while any(len(g) < n_new for g in gens):
            toks = np.zeros((B, k), np.int64)
            active = np.zeros((B,), bool)
            for i, g in enumerate(gens):
                if len(g) >= n_new:
                    continue
                active[i] = True
                # never draft past the remaining budget
                dr = list(draft.propose(
                    keys[i], min(k - 1, n_new - len(g) - 1)))[:k - 1]
                toks[i, :1 + len(dr)] = [g[-1]] + dr
            nxt, n_acc, _, _, pos = verify(
                self.aux, self.blocks, cache, pos,
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(active).to(dev))
            host = torch.cat([n_acc[:, None], nxt], 1).cpu().numpy()
            for i, g in enumerate(gens):
                if not active[i]:
                    continue
                take = min(int(host[i, 0]) + 1, n_new - len(g))
                acc = [int(t) for t in host[i, 1:1 + take]]
                g.extend(acc)
                if len(g) < n_new:
                    draft.observe(keys[i], acc)

    @torch.inference_mode()
    def _spec_generate(self, toks, n_new, draft, k, temperature):
        """generate(draft=): the prompt through the single-token KV-cache
        step (the first token is generate(use_cache=True)'s), then verify
        rounds."""
        self._spec_check(len(toks), n_new, temperature)
        draft, k = self._unwrap_draft(draft, k)
        cache = init_kv_cache(len(self.blocks), 1, self.max_len,
                              self.aux.tok.shape[1], self.n_heads,
                              self.aux.tok.dtype, self.device)
        logit = None
        for pos, t in enumerate(toks):
            logit = self._decode_step(
                cache, pos, torch.tensor([t], device=self.device))[0]
        gens = [[int(logit.float().argmax())]]
        key = object()                      # this call's draft stream
        draft.start(key, toks + gens[0])
        try:
            self._spec_rounds(_with_spare_slot(cache),
                              torch.tensor([len(toks)], device=self.device),
                              gens, n_new, draft, [key], k)
        finally:
            draft.stop(key)
        return toks + gens[0]

    @torch.inference_mode()
    def _spec_generate_batch(self, prompts, n_new, draft, k, temperature):
        """generate_batch(draft=): one parallel prefill, then verify rounds
        over every row."""
        prompts = self._tokens(prompts)
        B, P = prompts.shape
        self._spec_check(P, n_new, temperature)
        draft, k = self._unwrap_draft(draft, k)
        h, cache = prefill_forward(self.aux, self.blocks, prompts,
                                   self.n_heads, self.max_len)
        first = logits_fn(self.aux, h[:, -1]).float().argmax(-1).cpu()
        prompts_np = prompts.cpu().numpy()
        gens = [[int(first[i])] for i in range(B)]
        keys = [object() for _ in range(B)]
        for i in range(B):
            draft.start(keys[i], prompts_np[i].tolist() + gens[i])
        try:
            self._spec_rounds(_with_spare_slot(cache),
                              torch.full((B,), P, device=self.device),
                              gens, n_new, draft, keys, k)
        finally:
            for key in keys:
                draft.stop(key)
        return np.concatenate([prompts_np, np.asarray(gens, np.int64)], 1)

    def _check_cache_room(self, n_prompt, n_new):
        if n_prompt + n_new > self.max_len:
            raise ValueError(
                f"prompt+new tokens ({n_prompt}+{n_new}) exceed max_len "
                f"{self.max_len} (the KV cache has no sliding window)")

    @torch.inference_mode()
    def generate(self, prompt, max_new_tokens=32, temperature=0.0, seed=0,
                 use_cache=False, draft=None, speculate_k=4):
        """Autoregressive continuation of `prompt` (token ids); returns the
        list prompt + new tokens. temperature 0 = greedy argmax on f32
        logits; > 0 = sampled on the host with np.random.default_rng(seed),
        as the JAX package does.

        use_cache=False re-encodes the context (at most max_len tokens) for
        every new token: the full causal forward, through the flash kernel
        when attention="flash". use_cache=True feeds the prompt, then each
        new token, through the single-token KV-cache decode step.

        draft=<DraftSource or Speculator> (serving/speculate.py) turns on
        SPECULATIVE greedy decode: `speculate_k`-wide verify calls accept
        up to K tokens each; acceptance is by exact argmax match, so a bad
        draft costs speed, never tokens."""
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        if not toks:
            raise ValueError("prompt must contain at least one token")
        if draft is not None:
            return self._spec_generate(toks, int(max_new_tokens), draft,
                                       speculate_k, temperature)
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
                       seed=0, draft=None, speculate_k=4):
        """Batched KV-cache decode of equal-length `prompts` [B, P]: one
        parallel prefill fills every layer's cache, then one decode step per
        new token. temperature <= 0 = greedy (argmax on f32 logits);
        > 0 = sampled on the device from a torch.Generator seeded with
        `seed` (deterministic per seed; not the JAX package's draws).
        Returns a numpy array [B, P + max_new_tokens]. `draft` /
        `speculate_k` as in `generate`: rows advance 1..K tokens per verify
        call independently, finished rows go inactive."""
        if draft is not None:
            return self._spec_generate_batch(prompts, int(max_new_tokens),
                                             draft, speculate_k,
                                             temperature)
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
