"""Plain PyTorch pieces the reference models share: convolutions with
XLA's SAME padding, dense products, BatchNorm over the batch, the softmax
cross entropy, the Nesterov update, and the inputs the benchmark makes
from a seed (weights and image pools).

Everything computes in float32 with TF32 off (`strict_f32`). `Numerics`
says how the tensors that the configuration holds in its compute type
are rounded: not at all (the reference), or to float8 (the control: the
step below the configurations' bfloat16; e4m3 with a per-tensor scale,
e5m2 for the gradients, as float8 training recipes round them).

Imports nothing of the measured program.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F


def strict_f32():
    """float32 products and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def subseed(seed, tag):
    """A 63-bit seed for one stream (`tag`: "weights", "data", ...) drawn
    from the run's seed, so the streams are independent of one another."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


# -- rounding: the control's float8 -----------------------------------------

def _round(t, dtype, fmax):
    """`t` rounded to the float8 `dtype` under a per-tensor scale that maps
    its largest magnitude to `fmax`, back in t's type."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / fmax
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """A tensor held in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Numerics:
    """Where the configuration holds a tensor in its compute type (the
    input, the weights' copies, every layer's output, the logits and
    their log-softmax), `hold` rounds it: not at all ("f32", the
    reference) or to float8 with a per-tensor scale, e4m3 forward and
    e5m2 for its gradient ("fp8", the control: the precision below the
    configurations' bfloat16)."""

    def __init__(self, kind="f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def hold(self, t):
        return _Fp8.apply(t) if self.kind == "fp8" else t


F32 = Numerics("f32")


# -- layers -----------------------------------------------------------------

def same_pads(size, k, s):
    """SAME padding of one axis: out = ceil(size / s), the total padding
    split with the extra cell after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w_hwio, stride, num=F32, bias=None):
    """A SAME convolution of NCHW `x` with an HWIO kernel."""
    kh, kw = int(w_hwio.shape[0]), int(w_hwio.shape[1])
    t, b = same_pads(int(x.shape[2]), kh, stride)
    left, right = same_pads(int(x.shape[3]), kw, stride)
    if t or b or left or right:
        x = F.pad(x, (left, right, t, b))
    y = F.conv2d(x, num.hold(w_hwio.permute(3, 2, 0, 1)), stride=stride)
    if bias is not None:
        y = y + num.hold(bias).view(1, -1, 1, 1)
    return num.hold(y)


def max_pool_same(x, k, s):
    t, b = same_pads(int(x.shape[2]), k, s)
    left, right = same_pads(int(x.shape[3]), k, s)
    return F.max_pool2d(F.pad(x, (left, right, t, b), value=float("-inf")),
                        k, s)


def dense(x, w, b, num=F32):
    return num.hold(x @ num.hold(w) + num.hold(b))


def batch_norm_train(x, gamma, beta, eps):
    """(y, batch mean, biased batch variance) over every axis but the
    channel."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    y = ((x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + eps).view(1, -1, 1, 1)
         * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1))
    return y, mean.detach(), var.detach()


def batch_norm_infer(x, gamma, beta, mean, var, eps, num=F32):
    """Inference over the running statistics, op by op, each result held
    in the compute type (as the configurations' bfloat16 inference
    computes it)."""
    h = num.hold

    def c(v):
        return h(v).view(1, -1, 1, 1)

    xn = h(h(x - c(mean)) / h(torch.sqrt(h(c(var) + eps))))
    return h(h(xn * c(gamma)) + c(beta))


def cross_entropy(logits, labels, num=F32):
    """The mean over the batch of -sum(labels * log softmax(logits))."""
    logp = num.hold(torch.log_softmax(logits, dim=-1))
    return -(labels * logp).sum(dim=-1).mean()


def images(u8, scale=np.float32(1.0 / 255.0)):
    """uint8 NHWC pixels as the float32 NCHW batch in [0, 1]: each pixel
    times the scaler's factor 1/255 as float32 holds it, rounded once."""
    return (u8.permute(0, 3, 1, 2).to(torch.float64) * float(scale)).float()


@torch.no_grad()
def nesterov(params, grads, velocity, lr, momentum):
    """One Nesterov step in place (ND4J's form): v' = mu v - lr g; the
    parameter moves by -mu v + (1 + mu) v'."""
    for key, p in params.items():
        v = velocity[key]
        v_new = momentum * v - lr * grads[key]
        p.add_(-momentum * v + (1.0 + momentum) * v_new)
        v.copy_(v_new)


# -- inputs made from a seed -------------------------------------------------

def make_params(leaves, seed, device):
    """The initial parameters, {(vertex, name): float32 tensor on
    `device`}, in the reference layout. `leaves` lists (vertex, name,
    shape, init, std) with init "normal" (zero mean, standard deviation
    `std`), "zeros" or "ones". The normals come from one draw of a
    generator on the device seeded from `seed`'s "weights" stream."""
    gen = torch.Generator(device).manual_seed(subseed(seed, "weights"))
    n = sum(int(np.prod(s)) for _, _, s, init, _ in leaves
            if init == "normal")
    buf = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for vertex, name, shape, init, std in leaves:
        if init == "normal":
            size = int(np.prod(shape))
            t = buf[offset:offset + size].view(shape)
            t.mul_(float(std))
            offset += size
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r}")
        out[(vertex, name)] = t
    return out


def to_host(params):
    """The same parameters as numpy arrays, through one copy of each
    distinct storage."""
    host = {}
    bases = {}
    for key, t in params.items():
        base = t._base if t._base is not None else t
        if id(base) not in bases:
            bases[id(base)] = (base, base.cpu())
        src, cpu = bases[id(base)]
        if t._base is None:
            host[key] = cpu.numpy()
        else:
            flat = cpu.reshape(-1)
            start = t.storage_offset() - src.storage_offset()
            host[key] = flat[start:start + t.numel()].view(t.shape).numpy()
    return host


def image_pool(n_rows, height, width, channels, n_classes, seed, device,
               tag="data"):
    """(uint8 NHWC pixels, one-hot float32 labels) of `n_rows` images,
    uniform pixels and classes, drawn on `device` from `seed`'s `tag`
    stream; returned on the host as numpy."""
    gen = torch.Generator(device).manual_seed(subseed(seed, tag))
    x = torch.randint(0, 256, (n_rows, height, width, channels),
                      generator=gen, device=device, dtype=torch.uint8)
    y = torch.randint(0, n_classes, (n_rows,), generator=gen, device=device)
    labels = np.zeros((n_rows, n_classes), np.float32)
    labels[np.arange(n_rows), y.cpu().numpy()] = 1.0
    return x.cpu().numpy(), labels
