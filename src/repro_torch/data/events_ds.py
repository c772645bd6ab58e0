"""Event-stream datasets: the synthetic training stream and real DVS
recording I/O.

Counterpart of ``repro.data.events_ds``, in two halves:

1. the synthetic generator with DVS-Gesture / NMNIST statistics
   (:class:`EventDatasetSpec`, :func:`batch_at`): class-anchored Gaussian
   blobs orbiting at class-specific speeds, Bernoulli spikes at the
   paper's 1.2%-4.9% activity.  It draws from a ``torch.Generator`` on the
   target device, seeded by a pure function of ``(seed, index)``, so the
   data cursor is the step index; JAX's PRNG is not matched, only the
   body that turns the draws into spikes (:func:`_sample_one`);
2. recording ingestion for serving and training: a :class:`DVSRecording`
   of raw microsecond-timestamped address events, loaders and writers for
   the portable ``.npz`` format and AEDAT3.1 (the DVS-Gesture release
   format; each package reads what the other writes), binning
   into the engine's ``EventStream`` (:func:`recording_to_stream`),
   segmentation into requests (:func:`segment_recording`) or dense
   training windows (:func:`recording_dense_windows`), the numpy-only
   synthetic recording (:func:`synthesize_recording`) and the paced
   replay of segments into an engine (:class:`ReplayClient`).  Host-side
   numpy; streams are CPU tensors, which the engine's collector reads as
   numpy.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pathlib
import struct
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.device import resolve_device

# the sample recordings and checkpoint ship with the reference package
SAMPLES_DIR = (pathlib.Path(__file__).resolve().parents[2] / "repro" / "data"
               / "samples")


@dataclasses.dataclass(frozen=True)
class EventDatasetSpec:
    """Geometry and statistics of one synthetic event dataset."""

    n_classes: int = 11
    height: int = 128
    width: int = 128
    polarities: int = 2
    n_timesteps: int = 100
    base_activity: float = 0.02   # mean fraction of active pixels per step
    n_blobs: int = 3


DVS_GESTURE = EventDatasetSpec()
NMNIST = EventDatasetSpec(n_classes=10, height=34, width=34, n_timesteps=60,
                          base_activity=0.03, n_blobs=2)
TINY = EventDatasetSpec(n_classes=4, height=12, width=12, n_timesteps=16,
                        base_activity=0.06, n_blobs=1)


def _sample_one(labels: torch.Tensor, phase_u: torch.Tensor,
                act_u: torch.Tensor, u: torch.Tensor,
                spec: EventDatasetSpec) -> torch.Tensor:
    """The reference's class-anchored body with its random draws passed
    in, batched: ``labels (B,)``, ``phase_u (B, n_blobs)`` uniform in
    [0, 1), ``act_u (B,)`` uniform in [0.6, 2.4), ``u (B, T, H, W, C)``
    uniform in [0, 1) -> float32 binary spikes ``(B, T, H, W, C)``."""
    T, H, W, C = (spec.n_timesteps, spec.height, spec.width, spec.polarities)
    dev = u.device
    f32 = torch.float32
    lab = labels.to(f32)[:, None, None]                      # (B, 1, 1)
    b = torch.arange(spec.n_blobs, dtype=f32, device=dev)    # (nb,)
    omega = 0.05 + 0.035 * lab + 0.02 * b                    # (B, 1, nb)
    radius = (0.14 + 0.03 * b + 0.01 * lab) * min(H, W)
    phase0 = phase_u[:, None] * 2 * math.pi + lab * 0.7
    act = spec.base_activity * act_u                         # (B,)
    t = torch.arange(T, dtype=f32, device=dev)[:, None]      # (T, 1)
    ang = omega * t + phase0                                 # (B, T, nb)
    theta = 2.0 * math.pi * lab / spec.n_classes
    cy0 = H * (0.5 + 0.22 * torch.sin(theta))
    cx0 = W * (0.5 + 0.22 * torch.cos(theta))
    cy = cy0 + radius * torch.sin(ang)
    cx = cx0 + radius * torch.cos(ang)
    pol_bias = 0.5 + 0.5 * torch.sin(ang + 0.5)              # (B, T, nb)
    yy = torch.arange(H, dtype=f32, device=dev)[:, None]
    xx = torch.arange(W, dtype=f32, device=dev)[None, :]
    sig2 = (0.06 * min(H, W)) ** 2
    d2 = ((yy - cy[..., None, None]) ** 2
          + (xx - cx[..., None, None]) ** 2)                 # (B,T,nb,H,W)
    inten = torch.exp(-d2 / (2 * sig2))
    p_on = (inten * pol_bias[..., None, None]).amax(2)
    p_off = (inten * (1 - pol_bias)[..., None, None]).amax(2)
    inten = torch.stack([p_on, p_off], -1)                   # (B,T,H,W,2)
    scale = (act[:, None, None, None, None] * H * W * C
             / torch.clamp(inten.sum((2, 3, 4), keepdim=True), min=1e-6)
             * T)
    prob = torch.clamp(inten * scale / T, 0.0, 0.75)
    return (u < prob).to(f32)


def _draws(gen: torch.Generator, n: int, spec: EventDatasetSpec):
    """The random inputs of ``n`` samples, drawn from ``gen`` on its
    device: labels, blob phases, activity factors, Bernoulli uniforms."""
    dev = gen.device
    labels = torch.randint(0, spec.n_classes, (n,), generator=gen,
                           device=dev)
    phase_u = torch.rand((n, spec.n_blobs), generator=gen, device=dev)
    act_u = torch.rand((n,), generator=gen, device=dev) * 1.8 + 0.6
    u = torch.rand((n, spec.n_timesteps, spec.height, spec.width,
                    spec.polarities), generator=gen, device=dev)
    return labels, phase_u, act_u, u


def sample(gen: torch.Generator, spec: EventDatasetSpec
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``(spikes (T, H, W, C), label)`` pair on ``gen``'s device."""
    labels, phase_u, act_u, u = _draws(gen, 1, spec)
    return _sample_one(labels, phase_u, act_u, u, spec)[0], labels[0]


def _cursor_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by a pure function of
    ``(seed, index)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, index])
                        .generate_state(1, np.uint64)[0]))
    return gen


def batch_at(seed: int, index: int, batch_size: int, spec: EventDatasetSpec,
             device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``index`` of the stream: ``(spikes (B, T, H, W, C) float32,
    labels (B,) int64)`` made on ``device`` (default: CUDA), a pure
    function of ``(seed, index)`` on that device, which is what makes the
    data pipeline checkpointable by cursor alone."""
    gen = _cursor_generator(seed, index, resolve_device(device))
    labels, phase_u, act_u, u = _draws(gen, batch_size, spec)
    return _sample_one(labels, phase_u, act_u, u, spec), labels


def batches(seed: int, batch_size: int, spec: EventDatasetSpec, device=None
            ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Deterministic, restartable batch stream (cursor = batch index)."""
    i = 0
    while True:
        yield batch_at(seed, i, batch_size, spec, device)
        i += 1


@dataclasses.dataclass
class DVSRecording:
    """Raw address events from a DVS sensor, microsecond timestamps.

    ``x`` is the sensor column, ``y`` the row; arrays are time-sorted
    (sorted stably on construction if not); ``p`` is the polarity bit.
    """

    t: np.ndarray            # int64, microseconds, sorted ascending
    x: np.ndarray            # int32, column in [0, width)
    y: np.ndarray            # int32, row in [0, height)
    p: np.ndarray            # int8, polarity 0/1
    width: int
    height: int
    label: Optional[int] = None
    name: str = ""

    def __post_init__(self):
        n = len(self.t)
        if not (len(self.x) == len(self.y) == len(self.p) == n):
            raise ValueError("t/x/y/p must have equal length")
        if n and (np.diff(self.t) < 0).any():
            order = np.argsort(self.t, kind="stable")
            self.t, self.x, self.y, self.p = (a[order] for a in
                                              (self.t, self.x, self.y, self.p))

    @property
    def n_events(self) -> int:
        """Number of address events."""
        return len(self.t)

    @property
    def duration_us(self) -> int:
        """Span from the first to the last event, inclusive."""
        return int(self.t[-1] - self.t[0]) + 1 if self.n_events else 0


def save_events_npz(path: str, rec: DVSRecording) -> None:
    """Write the portable ``.npz`` event format (version 1, compressed):
    what the reference's ``load_events_npz`` reads."""
    np.savez_compressed(
        path, format_version=1,
        t=rec.t.astype(np.int64), x=rec.x.astype(np.int32),
        y=rec.y.astype(np.int32), p=rec.p.astype(np.int8),
        width=rec.width, height=rec.height,
        label=-1 if rec.label is None else int(rec.label))


def load_events_npz(path: str) -> DVSRecording:
    """Load the portable ``.npz`` event format (version 1)."""
    with np.load(path) as z:
        if int(z["format_version"]) != 1:
            raise ValueError(f"{path}: unsupported event npz version "
                             f"{int(z['format_version'])}")
        label = int(z["label"])
        return DVSRecording(
            t=z["t"].astype(np.int64), x=z["x"].astype(np.int32),
            y=z["y"].astype(np.int32), p=z["p"].astype(np.int8),
            width=int(z["width"]), height=int(z["height"]),
            label=None if label < 0 else label,
            name=os.path.basename(path))


# AEDAT 3.1 (cAER): '#' header lines from '#!AER-DAT3.1' to '#!END-HEADER',
# then packets of a 28-byte header (int16 x2, int32 x6) and a payload of
# eventCapacity events; POLARITY_EVENT payloads are 8 bytes per event (a
# uint32 data word: bit 0 valid, bit 1 polarity, bits 2-16 y, bits 17-31 x;
# and an int32 timestamp extended by the packet's eventTSOverflow).
_AEDAT_MAGIC = b"#!AER-DAT3.1"
_AEDAT_END = b"#!END-HEADER"
_POLARITY_EVENT = 1
_PKT_HDR = struct.Struct("<hhiiiiii")


def load_events_aedat(path: str, max_events: Optional[int] = None,
                      width: int = 128, height: int = 128) -> DVSRecording:
    """Parse an AEDAT3.1 file's polarity events into a :class:`DVSRecording`.

    Other packet types are skipped and invalid events dropped;
    ``max_events`` truncates early.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_AEDAT_MAGIC):
        raise ValueError(f"{path}: not an AEDAT3.1 file (header starts "
                         f"{data[:16]!r}; expected {_AEDAT_MAGIC!r})")
    end = data.find(_AEDAT_END)
    if end < 0:
        raise ValueError(f"{path}: missing {_AEDAT_END!r} line")
    pos = data.index(b"\n", end) + 1
    words, stamps = [], []
    n_seen = 0
    while pos + _PKT_HDR.size <= len(data):
        (etype, _src, esize, _tsoff, tsovf, cap, enum_, _evalid) = \
            _PKT_HDR.unpack_from(data, pos)
        pos += _PKT_HDR.size
        payload = esize * cap
        if payload < 0 or enum_ > cap or pos + payload > len(data):
            raise ValueError(f"{path}: truncated event packet at byte {pos}")
        if etype == _POLARITY_EVENT and esize == 8 and enum_ > 0:
            arr = np.frombuffer(data, np.uint32, count=2 * enum_,
                                offset=pos).reshape(enum_, 2)
            words.append(arr[:, 0])
            stamps.append((arr[:, 1].astype(np.int64) & 0x7FFFFFFF)
                          + (np.int64(tsovf) << 31))
            n_seen += enum_
        pos += payload
        if max_events is not None and n_seen >= max_events:
            break
    if not words:
        w = np.zeros((0,), np.uint32)
        s = np.zeros((0,), np.int64)
    else:
        w = np.concatenate(words)
        s = np.concatenate(stamps)
    if max_events is not None:
        w, s = w[:max_events], s[:max_events]
    valid = (w & 1) != 0
    w, s = w[valid], s[valid]
    return DVSRecording(
        t=s,
        x=((w >> 17) & 0x7FFF).astype(np.int32),
        y=((w >> 2) & 0x7FFF).astype(np.int32),
        p=((w >> 1) & 1).astype(np.int8),
        width=width, height=height, name=os.path.basename(path))


def save_events_aedat(path: str, rec: DVSRecording,
                      events_per_packet: int = 4096) -> None:
    """Write a minimal AEDAT3.1 file (polarity events only) that
    :func:`load_events_aedat` and the reference's loader read back.

    A packet carries one ``eventTSOverflow``, so packets split where the
    31-bit timestamp wraps.  Timestamps must be non-negative.
    """
    if rec.n_events and int(rec.t.min()) < 0:
        raise ValueError("AEDAT timestamps must be non-negative")
    ovf_all = rec.t.astype(np.int64) >> 31
    with open(path, "wb") as f:
        f.write(_AEDAT_MAGIC + b"\r\n")
        f.write(b"#Format: RAW\r\n")
        f.write(f"#Source 1: DVS{rec.width}\r\n".encode())
        f.write(_AEDAT_END + b"\r\n")
        lo = 0
        while lo < rec.n_events:
            hi = min(lo + events_per_packet, rec.n_events)
            ovf = int(ovf_all[lo])
            hi = lo + max(int(np.searchsorted(ovf_all[lo:hi], ovf + 1)), 1)
            n = hi - lo
            payload = np.empty((n, 2), np.uint32)
            payload[:, 0] = (np.uint32(1)
                             | (rec.p[lo:hi].astype(np.uint32) << 1)
                             | ((rec.y[lo:hi].astype(np.uint32) & 0x7FFF)
                                << 2)
                             | ((rec.x[lo:hi].astype(np.uint32) & 0x7FFF)
                                << 17))
            payload[:, 1] = (rec.t[lo:hi].astype(np.int64)
                             & 0x7FFFFFFF).astype(np.uint32)
            f.write(_PKT_HDR.pack(_POLARITY_EVENT, 0, 8, 4, ovf, n, n, n))
            f.write(payload.tobytes())
            lo = hi


def load_recording(path: str) -> DVSRecording:
    """Load a recording by extension: ``.npz`` or ``.aedat``."""
    if path.endswith(".npz"):
        return load_events_npz(path)
    if path.endswith((".aedat", ".aedat3")):
        return load_events_aedat(path)
    raise ValueError(f"unknown recording format: {path} "
                     f"(expected .npz or .aedat)")


def sample_recording_path(name: str = "tiny_gesture.npz") -> str:
    """Path of a bundled sample file (recording or trained checkpoint)."""
    p = SAMPLES_DIR / name
    if not p.exists():
        raise FileNotFoundError(f"bundled sample missing: {p}")
    return str(p)


def _stream(t, x, y, c, valid) -> ev.EventStream:
    cap = len(t)
    return ev.EventStream(
        t=torch.as_tensor(t, dtype=torch.int32),
        x=torch.as_tensor(x, dtype=torch.int32),
        y=torch.as_tensor(y, dtype=torch.int32),
        c=torch.as_tensor(c, dtype=torch.int32),
        op=torch.full((cap,), ev.OP_UPDATE, dtype=torch.int32),
        valid=torch.as_tensor(valid, dtype=torch.bool))


def recording_to_stream(rec: DVSRecording, in_shape: Tuple[int, int, int],
                        n_timesteps: int, window_us: Optional[int] = None,
                        t0_us: Optional[int] = None,
                        align: int = 8) -> Tuple[ev.EventStream, int]:
    """Bin a raw recording into the engine's input event representation.

    Timestamps fall into ``n_timesteps`` bins of ``window_us`` (default:
    the duration split evenly); sensor coordinates are integer-downscaled
    onto ``(H, W)``; polarity is the channel (collapsed for one channel);
    events on the same (bin, site) are deduplicated into one binary spike.
    Returns ``(stream, n_raw_events)``, the stream time-sorted with its
    capacity padded to ``align``.
    """
    H, W, C = in_shape
    if rec.n_events == 0:
        z = np.zeros((align,), np.int64)
        return _stream(np.full((align,), n_timesteps), z, z, z,
                       np.zeros((align,), bool)), 0
    t0 = int(rec.t[0]) if t0_us is None else int(t0_us)
    if window_us is None:
        window_us = max(1, -(-rec.duration_us // n_timesteps))
    tb = (rec.t - t0) // window_us
    keep = (tb >= 0) & (tb < n_timesteps)
    fy = max(1, -(-rec.height // H))          # ceil-div downscale factors
    fx = max(1, -(-rec.width // W))
    rows = rec.y[keep] // fy
    cols = rec.x[keep] // fx
    chan = rec.p[keep].astype(np.int64) if C > 1 else np.zeros(keep.sum(),
                                                              np.int64)
    keep2 = (rows < H) & (cols < W) & (chan < C)
    quad = np.stack([tb[keep].astype(np.int64)[keep2], rows[keep2],
                     cols[keep2], chan[keep2]], axis=1)
    quad = np.unique(quad, axis=0)            # dedupe; lexsorted (t,x,y,c)
    n = len(quad)
    cap = max(align, -(-n // align) * align)
    pad = cap - n
    t = np.concatenate([quad[:, 0], np.full((pad,), n_timesteps)])
    x = np.concatenate([quad[:, 1], np.zeros((pad,), np.int64)])
    y = np.concatenate([quad[:, 2], np.zeros((pad,), np.int64)])
    c = np.concatenate([quad[:, 3], np.zeros((pad,), np.int64)])
    return _stream(t, x, y, c, np.arange(cap) < n), int(rec.n_events)


def segment_recording(rec: DVSRecording, in_shape: Tuple[int, int, int],
                      n_timesteps: int, window_us: int,
                      uid_base: int = 0) -> List["EventRequest"]:  # noqa: F821
    """Chop a continuous recording into per-inference ``EventRequest``s of
    ``n_timesteps`` bins of ``window_us`` each, in arrival order."""
    from repro_torch.serve.event_engine import EventRequest  # data<->serve
    return [EventRequest(uid=uid_base + i, stream=stream,
                         n_timesteps=n_timesteps)
            for i, stream in enumerate(_segment_streams(
                rec, in_shape, n_timesteps, window_us))]


def _segment_streams(rec: DVSRecording, in_shape: Tuple[int, int, int],
                     n_timesteps: int, window_us: int
                     ) -> List[ev.EventStream]:
    """Every ``n_timesteps * window_us`` segment of ``rec`` binned by
    :func:`recording_to_stream`, in order."""
    seg_us = n_timesteps * window_us
    n_seg = max(1, -(-rec.duration_us // seg_us))
    t0 = int(rec.t[0]) if rec.n_events else 0
    bounds = np.searchsorted(rec.t, t0 + seg_us * np.arange(n_seg + 1))
    out = []
    for i in range(n_seg):
        lo, hi = bounds[i], bounds[i + 1]
        seg = DVSRecording(t=rec.t[lo:hi], x=rec.x[lo:hi], y=rec.y[lo:hi],
                           p=rec.p[lo:hi], width=rec.width,
                           height=rec.height, label=rec.label, name=rec.name)
        stream, _ = recording_to_stream(
            seg, in_shape, n_timesteps, window_us=window_us,
            t0_us=t0 + i * seg_us)
        out.append(stream)
    return out


def recording_dense_windows(rec: DVSRecording,
                            in_shape: Tuple[int, int, int],
                            n_timesteps: int, window_us: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Densify a recording into training windows: the segments
    :func:`segment_recording` serves, each scattered into a binary
    ``(T, H, W, C)`` tensor.  Every window takes the recording's label
    (``None`` is class 0).  Returns CPU tensors ``(spikes (S, T, H, W, C)
    float32, labels (S,) int64)``."""
    wins = [ev.events_to_dense(s, (n_timesteps,) + tuple(in_shape))
            for s in _segment_streams(rec, in_shape, n_timesteps, window_us)]
    label = 0 if rec.label is None else int(rec.label)
    return torch.stack(wins), torch.full((len(wins),), label,
                                         dtype=torch.int64)


class ReplayClient:
    """Replays recording segments into an engine at sensor pace.

    Each engine window covers ``window * window_us`` of sensor time; the
    client admits segment *i* no earlier than its recording-relative
    arrival time and sleeps off whatever wall-time budget remains after
    each engine step — i.e. real inter-window timing, scaled by
    ``speedup`` (1.0 = true real time).  With the idle skip on, sparse
    stretches of the recording leave that budget almost entirely to
    sleeping, which is exactly the serving-scale idle-costs-nothing story.
    """

    def __init__(self, requests: Sequence["EventRequest"], n_timesteps: int,
                 window_us: int, speedup: float = 1000.0):
        if speedup <= 0:
            raise ValueError("speedup must be > 0")
        self.requests = list(requests)
        self.n_timesteps = n_timesteps
        self.window_us = window_us
        self.speedup = speedup
        self.stats = {"wall_s": 0.0, "slept_s": 0.0, "stalled_windows": 0}

    def run(self, engine, max_windows: int = 100_000) -> None:
        """Admit at arrival times, step, pace; returns when all are done."""
        seg_s = self.n_timesteps * self.window_us * 1e-6 / self.speedup
        win_s = engine.W * self.window_us * 1e-6 / self.speedup
        pending = list(self.requests)
        arrivals = [i * seg_s for i in range(len(pending))]
        start = time.time()
        for _ in range(max_windows):
            now = time.time() - start
            while (pending and arrivals[0] <= now
                   and engine.try_admit(pending[0])):
                pending.pop(0)
                arrivals.pop(0)
            if pending and arrivals[0] <= now and engine.n_free == 0:
                self.stats["stalled_windows"] += 1   # back-pressure visible
            t_win = time.time()
            n = engine.step()
            if n == 0 and not pending:
                break
            # real inter-window timing: a window of sensor time must not be
            # consumed faster than the (scaled) sensor emits it
            budget = win_s - (time.time() - t_win)
            if n == 0 and pending:
                # engine drained before the next arrival — wait for it
                budget = max(budget, arrivals[0] - (time.time() - start))
            if budget > 0:
                self.stats["slept_s"] += budget
                time.sleep(budget)
        else:
            raise RuntimeError("max_windows exceeded before drain")
        self.stats["wall_s"] = time.time() - start


def synthesize_recording(seed: int = 0, width: int = 12, height: int = 12,
                         duration_us: int = 96_000, rate_hz: float = 40_000.0,
                         label: int = 2, name: str = "synthetic") -> DVSRecording:
    """Deterministic microsecond-timestamped gesture-like recording (the
    reference's numpy generator, copied: same seed, same events)."""
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
    return DVSRecording(t=t, x=x, y=y, p=p, width=width, height=height,
                        label=label, name=name)
