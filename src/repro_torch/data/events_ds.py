"""Real DVS recording ingestion for the serving engine.

Counterpart of the recording half of ``repro.data.events_ds``: a
:class:`DVSRecording` of raw microsecond-timestamped address events,
loaders for the portable ``.npz`` format and AEDAT3.1 (the DVS-Gesture
release format), binning into the engine's ``EventStream``
(:func:`recording_to_stream`), segmentation into requests
(:func:`segment_recording`) and the numpy-only synthetic recording
(:func:`synthesize_recording`).  All host-side numpy; streams are CPU
tensors, which the engine's collector reads as numpy.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import events as ev

# the sample recordings and checkpoint ship with the reference package
SAMPLES_DIR = (pathlib.Path(__file__).resolve().parents[2] / "repro" / "data"
               / "samples")


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
        out.append(EventRequest(uid=uid_base + i, stream=stream,
                                n_timesteps=n_timesteps))
    return out


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
