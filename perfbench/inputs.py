"""The inputs a run makes from its seed, handed alike to the port and to the
reference: weights, sensor recordings binned into events, training batches.

Copied from the port so that a later change to the program cannot move
the yardstick: :func:`synthesize_recording` is
``repro_torch.data.events_ds.synthesize_recording``, :func:`bin_recording`
the binning of ``recording_to_stream`` / ``segment_recording`` (one
segment from time zero), :func:`dvs_batch` the body of ``batch_at`` with
``DVS_GESTURE``'s statistics.  Nothing here imports the port.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def seed_words(seed: int, *salt: int) -> int:
    """A 63-bit seed for a generator, a pure function of the run's seed
    (any whole number) and a salt."""
    ss = np.random.SeedSequence([seed % (1 << 64)] + list(salt))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


# --- weights ---------------------------------------------------------------

def layer_shapes(config: dict) -> List[dict]:
    """Each layer of an eCNN configuration with its input and output
    geometry filled in (the shape rules of ``core.econv.EConvSpec``)."""
    shape = tuple(config["input"])
    out = []
    for layer in config["layers"]:
        H, W, C = shape
        k, s, p = layer["kernel"], layer["stride"], layer["padding"]
        if layer["kind"] == "conv":
            o = (H + 2 * p - k + 1, W + 2 * p - k + 1, layer["out_channels"])
            wshape, fan_in = (k, k, C, layer["out_channels"]), k * k * C
        elif layer["kind"] == "pool":
            o, wshape, fan_in = (H // s, W // s, C), (C,), s * s
        else:
            o = (1, 1, layer["out_channels"])
            wshape, fan_in = (H * W * C, layer["out_channels"]), H * W * C
        out.append(dict(layer, in_shape=shape, out_shape=o,
                        weight_shape=wshape, fan_in=fan_in))
        shape = o
    return out


def make_weights(config: dict, seed: int, device) -> List[torch.Tensor]:
    """Float32 weights on ``device`` from one ``torch.Generator`` there, in
    one draw: He-normal times ``gain`` for conv and fc (the scales of
    ``init_snn``), unit synapses for pool layers."""
    layers = layer_shapes(config)
    init = config["weight_init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed, 1))
    sizes = [math.prod(l["weight_shape"]) for l in layers
             if l["kind"] != "pool"]
    draw = torch.randn((sum(sizes),), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = [], 0
    for l in layers:
        if l["kind"] == "pool":
            out.append(torch.full(l["weight_shape"], init["pool"],
                                  dtype=torch.float32, device=device))
            continue
        n = math.prod(l["weight_shape"])
        scale = np.float32((2.0 / l["fan_in"]) ** 0.5) * np.float32(
            init["gain"])
        out.append((draw[at:at + n] * float(scale)).reshape(
            l["weight_shape"]))
        at += n
    return out


# --- recordings ------------------------------------------------------------

def synthesize_recording(seed: int, width: int, height: int,
                         duration_us: int, rate_hz: float, label: int):
    """A gesture-like recording: (t us, x, y, p), as the port's generator."""
    rng = np.random.default_rng(seed)
    n = int(duration_us * 1e-6 * rate_hz)
    t = np.sort(rng.integers(0, duration_us, n)).astype(np.int64)
    ang = 2 * np.pi * t / 40_000.0 + 0.7 * label
    cy = height * 0.5 + 0.25 * height * np.sin(ang)
    cx = width * 0.5 + 0.25 * width * np.cos(ang)
    y = np.clip(np.round(cy + rng.normal(0, 0.08 * height, n)), 0,
                height - 1).astype(np.int32)
    x = np.clip(np.round(cx + rng.normal(0, 0.08 * width, n)), 0,
                width - 1).astype(np.int32)
    p = (np.sin(ang + 0.5) + rng.normal(0, 0.3, n) > 0).astype(np.int8)
    return t, x, y, p


def bin_recording(rec, sensor: Tuple[int, int], in_shape, n_timesteps: int,
                  timestep_us: int) -> np.ndarray:
    """Bin a recording into input events ``(n, 4)`` int64 ``(t, x, y, c)``
    from time zero: timesteps of ``timestep_us``, sensor coordinates
    downscaled onto ``in_shape`` (x the row), polarity the channel, one
    event per (timestep, site), lexicographically sorted."""
    t, x, y, p = rec
    H, W, C = in_shape
    height, width = sensor
    tb = t // timestep_us
    keep = (tb >= 0) & (tb < n_timesteps)
    rows = y[keep] // max(1, -(-height // H))
    cols = x[keep] // max(1, -(-width // W))
    chan = (p[keep].astype(np.int64) if C > 1
            else np.zeros(int(keep.sum()), np.int64))
    ok = (rows < H) & (cols < W) & (chan < C)
    # one key per (t, x, y, c), row-major: its sorted uniques are the
    # lexicographically sorted unique events
    key = np.unique(((tb[keep][ok] * H + rows[ok]) * W + cols[ok]) * C
                    + chan[ok])
    out = np.empty((len(key), 4), np.int64)
    for j, n in enumerate((C, W, H)):
        out[:, 3 - j] = key % n
        key = key // n
    out[:, 0] = key
    return out


def recording_pool(config: dict, mix: dict, seed: int) -> List[np.ndarray]:
    """The mix's pool of recordings for this seed, binned: each a full
    request of the configuration's timesteps."""
    height, width = config["sensor"]
    T, dt = config["n_timesteps"], config["timestep_us"]
    base = seed_words(seed, 2)
    return [bin_recording(
        synthesize_recording(seed=(base + i) % (1 << 63), width=width,
                             height=height, duration_us=T * dt,
                             rate_hz=mix["rate_hz"],
                             label=i % config["n_classes"]),
        (height, width), tuple(config["input"]), T, dt)
        for i in range(mix["pool"])]


def dense_frames(events: List[np.ndarray], n_timesteps: int, in_shape,
                 device) -> torch.Tensor:
    """Binary frames ``(B, T, H, W, C)`` float32 of binned recordings."""
    H, W, C = in_shape
    out = torch.zeros((len(events), n_timesteps, H, W, C),
                      dtype=torch.float32, device=device)
    for b, e in enumerate(events):
        if len(e):
            idx = torch.as_tensor(e, device=device)
            out[b, idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]] = 1.0
    return out


# --- training batches ------------------------------------------------------

def dvs_batch(seed: int, index: int, batch: int, spec: dict, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``index`` of a DVS-Gesture-like stream on ``device``:
    ``(spikes (B, T, H, W, C) float32, labels (B,) int64)``, a pure
    function of ``(seed, index)``.  Class-anchored Gaussian blobs orbiting
    at class-specific speeds, Bernoulli spikes at ``base_activity`` times
    U(0.6, 2.4) (the body of the port's ``batch_at``)."""
    T, H, W, C = (spec["n_timesteps"], spec["height"], spec["width"],
                  spec["polarities"])
    n_classes, nb = spec["n_classes"], spec["n_blobs"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed, 3, index))
    labels = torch.randint(0, n_classes, (batch,), generator=gen,
                           device=device)
    phase_u = torch.rand((batch, nb), generator=gen, device=device)
    act_u = torch.rand((batch,), generator=gen, device=device) * 1.8 + 0.6
    u = torch.rand((batch, T, H, W, C), generator=gen, device=device)
    f32 = torch.float32
    lab = labels.to(f32)[:, None, None]
    b = torch.arange(nb, dtype=f32, device=device)
    omega = 0.05 + 0.035 * lab + 0.02 * b
    radius = (0.14 + 0.03 * b + 0.01 * lab) * min(H, W)
    phase0 = phase_u[:, None] * 2 * math.pi + lab * 0.7
    act = spec["base_activity"] * act_u
    t = torch.arange(T, dtype=f32, device=device)[:, None]
    ang = omega * t + phase0
    theta = 2.0 * math.pi * lab / n_classes
    cy = H * (0.5 + 0.22 * torch.sin(theta)) + radius * torch.sin(ang)
    cx = W * (0.5 + 0.22 * torch.cos(theta)) + radius * torch.cos(ang)
    pol_bias = 0.5 + 0.5 * torch.sin(ang + 0.5)
    yy = torch.arange(H, dtype=f32, device=device)[:, None]
    xx = torch.arange(W, dtype=f32, device=device)[None, :]
    sig2 = (0.06 * min(H, W)) ** 2
    inten = torch.exp(-((yy - cy[..., None, None]) ** 2
                        + (xx - cx[..., None, None]) ** 2) / (2 * sig2))
    p_on = (inten * pol_bias[..., None, None]).amax(2)
    p_off = (inten * (1 - pol_bias)[..., None, None]).amax(2)
    inten = torch.stack([p_on, p_off], -1)[..., :C]
    scale = (act[:, None, None, None, None] * H * W * C
             / torch.clamp(inten.sum((2, 3, 4), keepdim=True), min=1e-6)
             * T)
    prob = torch.clamp(inten * scale / T, 0.0, 0.75)
    return (u < prob).to(f32), labels
