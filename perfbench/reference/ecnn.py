"""The plain reference of the eCNN family (the paper's Fig. 6 network and
SLAYER's N-MNIST network): plain PyTorch in float32, no kernel, no cache, no
batching of slots, nothing of the port.

* :func:`quantize` lowers float weights onto the int4 grid shared by a
  layer and the LIF plan into code units with an 8-bit state clip (the
  paper's §III-D4), from the float weights alone;
* :func:`serve` runs whole recordings through the integer-domain network
  frame by frame (leak toward zero, integrate, clip, fire, hard reset) and
  counts the class spikes, the events entering each layer at each
  timestep, and the distinct input sites of each layer in each window;
* :func:`train` runs the first steps of surrogate-gradient training with
  fake-quantised weights (QAT), the rate-decoded cross-entropy, frozen
  pool synapses and AdamW after a global-norm clip, with TF32 off.

``tf32=True`` is the training control: the operands of every convolution
and product rounded to TF32's 10-bit mantissa, as a TF32 unit takes them.
``state_bits`` below 8 is the serving control.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

INT4_MIN, INT4_MAX = -8, 7


def _f32(x, like):
    return torch.full((), x, dtype=torch.float32, device=like.device)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _RoundTf32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def synaptic_current(layer: dict, w: torch.Tensor, x: torch.Tensor,
                     tf32: bool = False) -> torch.Tensor:
    """A layer's input current for frames ``(N, H, W, C)`` -> ``(N, Ho,
    Wo, Co)``: a zero-padded convolution, a sum over each pool window
    times the channel's synapse, or a product with the flattened frame."""
    if tf32:
        w, x = _RoundTf32.apply(w), _RoundTf32.apply(x)
    Ho, Wo, Co = layer["out_shape"]
    if layer["kind"] == "conv":
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=layer["padding"]).permute(0, 2, 3, 1)
    if layer["kind"] == "pool":
        k = layer["stride"]
        C = x.shape[-1]
        return x[:, :Ho * k, :Wo * k].reshape((-1, Ho, k, Wo, k, C)).sum(
            (2, 4)) * w
    return x.reshape((x.shape[0], -1)) @ w


# --- serving ---------------------------------------------------------------

def quantize(layers: Sequence[dict], weights: Sequence[torch.Tensor],
             state_bits: int = 8):
    """Integer codes (float32 carrier) and the LIF plan in code units.

    A conv or fc layer's scale is its largest magnitude over 7 (a float32
    division), its codes ``clip(round_half_even(w / s), -8, 7)``; the
    threshold ``max(round(th / s), 1)``, the leak ``max(round(leak / s),
    0)``; pool synapses pass at scale 1.  The clip is ``2^(bits-1) - 1``.
    """
    codes, plans = [], []
    clip = float(2 ** (state_bits - 1) - 1)
    for layer, w in zip(layers, weights):
        if layer["kind"] == "pool":
            q, s = w, 1.0
        else:
            amax = w.abs().max()
            scale = (torch.maximum(amax, torch.full_like(amax, 1e-8))
                     / torch.full_like(amax, INT4_MAX))
            q = torch.clamp(torch.round(w / scale), INT4_MIN, INT4_MAX)
            s = float(scale)
        codes.append(q.to(torch.float32))
        plans.append({"threshold": float(max(round(layer["threshold"] / s),
                                             1)),
                      "leak": float(max(round(layer["leak"] / s), 0)),
                      "clip": clip})
    return codes, plans


@torch.no_grad()
def serve(layers: Sequence[dict], codes: Sequence[torch.Tensor],
          plans: Sequence[dict], frames: torch.Tensor, window: int
          ) -> Dict[str, torch.Tensor]:
    """Run binary input frames ``(B, T, H, W, C)`` through the network.

    Returns ``class_counts (B, n_classes)``, ``events (B, L, T)`` (the
    events entering layer l at timestep t: the previous layer's spikes, or
    the input's), ``out_events (B, T)`` (the last layer's spikes) and
    ``distinct (B, L, nW)`` (the input sites of layer l that carry an
    event in engine window w, ``window`` timesteps each).
    """
    B, T = frames.shape[:2]
    nW = -(-T // window)
    x = frames
    events, distinct = [], []
    for layer, w, plan in zip(layers, codes, plans):
        events.append((x != 0).flatten(2).sum(-1))
        pad = nW * window - T
        xs = F.pad((x != 0).flatten(2).float(), (0, 0, 0, pad))
        distinct.append(xs.reshape(B, nW, window, -1).amax(2).sum(-1))
        syn = synaptic_current(layer, w, x.reshape((B * T,)
                                                   + x.shape[2:]))
        syn = syn.reshape((B, T) + syn.shape[1:])
        th, leak, c = plan["threshold"], plan["leak"], plan["clip"]
        v = torch.zeros_like(syn[:, 0])
        out = []
        for t in range(T):
            v = torch.sign(v) * torch.clamp(v.abs() - leak, min=0.0)
            v = torch.clamp(v + syn[:, t], -c, c)
            s = (v >= th).to(torch.float32)
            v = v * (1.0 - s)
            out.append(s)
        x = torch.stack(out, 1)
    return {"class_counts": x.sum(1).flatten(1),
            "events": torch.stack(events, 1),
            "out_events": (x != 0).flatten(2).sum(-1),
            "distinct": torch.stack(distinct, 1)}


# --- training ----------------------------------------------------------------

class _Spike(torch.autograd.Function):
    """Heaviside forward; fast-sigmoid surrogate backward,
    ``g * beta / (2 (1 + beta |v - th|)^2)``."""

    @staticmethod
    def forward(ctx, v, threshold: float, beta: float):
        ctx.save_for_backward(v)
        ctx.threshold, ctx.beta = threshold, beta
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        x = torch.abs(v - ctx.threshold) * ctx.beta
        return g * (_f32(ctx.beta, x) / (2.0 * (1.0 + x) ** 2)), None, None


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(w: torch.Tensor) -> torch.Tensor:
    """Quantise onto the layer's shared int4 grid and back, the rounding
    passing its gradient straight through."""
    amax = w.abs().max()
    s = (torch.maximum(amax, torch.full_like(amax, 1e-8))
         / torch.full_like(amax, INT4_MAX))
    q = _SteRound.apply(w / s)
    q = torch.minimum(torch.maximum(q, torch.full_like(q, INT4_MIN)),
                      torch.full_like(q, INT4_MAX))
    return q * s


def forward_train(layers: Sequence[dict], weights: Sequence[torch.Tensor],
                  spikes: torch.Tensor, beta: float = 10.0,
                  tf32: bool = False) -> torch.Tensor:
    """Dense float forward ``(B, T, H, W, C)`` -> output spikes ``(B, T,
    1, 1, n_classes)`` with surrogate fires and QAT weights."""
    B, T = spikes.shape[:2]
    x = spikes
    for layer, w in zip(layers, weights):
        if layer["kind"] != "pool":
            w = fake_quant(w)
        syn = synaptic_current(layer, w, x.reshape((B * T,) + x.shape[2:]),
                               tf32=tf32)
        syn = syn.reshape((B, T) + syn.shape[1:])
        v = syn.new_zeros(syn[:, 0].shape)
        leak = layer["leak"]
        out = []
        for t in range(T):
            v = torch.sign(v) * torch.maximum(torch.abs(v) - _f32(leak, v),
                                              _f32(0.0, v))
            v = v + syn[:, t]
            s = _Spike.apply(v, layer["threshold"], beta)
            v = v * (1.0 - s)
            out.append(s)
        x = torch.stack(out, 1)
    return x


def _lr(step: int, opt: dict, device) -> torch.Tensor:
    """Warmup to ``lr`` over ``warmup`` steps, then a cosine to 10%, in
    float32 tensors."""
    s = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = opt["warmup"]
    if step < warm:
        return opt["lr"] * ((s + 1.0) / _f32(max(warm, 1), s))
    post = torch.clamp((s - warm) / _f32(max(opt["total"] - warm, 1), s),
                       0.0, 1.0)
    return opt["lr"] * (0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * post)))


def train(layers: Sequence[dict], weights: Sequence[torch.Tensor],
          batches: Sequence, opt: dict, tf32: bool = False) -> dict:
    """Run ``len(batches)`` training steps from ``weights``.

    Returns ``losses`` (one float each), ``first_grad`` (the clipped
    gradient of each layer at step 1, as the optimizer takes it) and
    ``weights`` after the last step.
    """
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    ws = [w.detach().clone() for w in weights]
    mu = [torch.zeros_like(w) for w in ws]
    nu = [torch.zeros_like(w) for w in ws]
    losses, first_grad = [], None
    with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for i, (spikes, labels) in enumerate(batches):
                leaves = [w.detach().requires_grad_() for w in ws]
                out = forward_train(layers, leaves, spikes, tf32=tf32)
                counts = out.sum(1).flatten(1)
                logp = torch.log_softmax(counts, -1)
                loss = (-logp.gather(-1, labels.long()[:, None])[:, 0]).mean()
                grads = torch.autograd.grad(loss, leaves)
                grads = [torch.zeros_like(g) if l["kind"] == "pool" else g
                         for g, l in zip(grads, layers)]
                with torch.no_grad():
                    norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                          for g in grads))
                    scale = torch.minimum(
                        _f32(1.0, norm), _f32(opt["max_grad_norm"], norm)
                        / torch.maximum(norm, _f32(1e-9, norm)))
                    grads = [g * scale for g in grads]
                    if i == 0:
                        first_grad = [g.clone() for g in grads]
                    t = _f32(float(i + 1), norm)
                    bc1 = 1.0 - torch.pow(_f32(b1, t), t)
                    bc2 = 1.0 - torch.pow(_f32(b2, t), t)
                    lr = _lr(i, opt, norm.device)
                    new = []
                    for w, g, m, n, layer in zip(ws, grads, mu, nu, layers):
                        m.copy_(m * b1 + g * (1.0 - b1))
                        n.copy_(n * b2 + torch.square(g) * (1.0 - b2))
                        delta = (m / bc1) / (torch.sqrt(n / bc2) + eps) \
                            + wd * w
                        new.append(w if layer["kind"] == "pool"
                                   else w - lr * delta)
                    ws = new
                losses.append(float(loss.detach()))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return {"losses": losses, "first_grad": first_grad, "weights": ws}


def flops_per_frame(layers: Sequence[dict]) -> int:
    """Dense forward operations of one frame: a multiply and an add per
    synapse of each conv and fc output, an add per pooled input and a
    multiply per pooled output."""
    total = 0
    for layer in layers:
        Ho, Wo, Co = layer["out_shape"]
        if layer["kind"] == "conv":
            k, ci = layer["kernel"], layer["in_shape"][2]
            total += 2 * k * k * ci * Co * Ho * Wo
        elif layer["kind"] == "pool":
            s = layer["stride"]
            total += (s * s + 1) * Ho * Wo * Co
        else:
            total += 2 * math.prod(layer["in_shape"]) * Co
    return total


def updates_per_event(layer: dict) -> int:
    """Neuron updates one input event triggers (nominal)."""
    if layer["kind"] == "conv":
        return layer["kernel"] ** 2 * layer["out_shape"][2]
    if layer["kind"] == "pool":
        return 1
    return layer["out_shape"][2]


def state_sites(layer: dict) -> int:
    """Membranes a slot holds in this layer."""
    return math.prod(layer["out_shape"])


def weight_elems(layer: dict) -> int:
    """Weights of a layer."""
    return math.prod(layer["weight_shape"])
