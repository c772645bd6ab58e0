"""Deterministic synthetic token pipeline (sharded, checkpointable),
counterpart of ``repro.data.lm_ds``.

Tokens follow a noisy affine bigram process: with probability ``p_struct``
the next token is ``(a * tok + b) mod vocab``, else uniform noise.  The
structure is learnable within a few hundred steps, and a batch is a pure
function of ``(seed, index, shard)``: each data-parallel rank makes its own
shard, and the pipeline's cursor is one integer.

JAX's PRNG bits cannot be reproduced in torch, so a batch is made in two
parts: :func:`draws` takes the random inputs (the first token, the noise
tokens and the structure coin) from a ``torch.Generator`` seeded from
``(seed, index, shard)``, and :func:`bigram` is the recurrence over them,
a pure function that, given JAX's own draws, equals the reference's
``batch_at`` bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LmDatasetSpec:
    vocab_size: int
    seq_len: int
    p_struct: float = 0.9
    a: int = 31
    b: int = 17


def draws(spec: LmDatasetSpec, seed: int, index: int, rows: int,
          shard: int = 0, device=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The random inputs of ``rows`` sequences: ``first`` (rows, 1) and
    ``noise`` (rows, S) int64 tokens, uniform in [0, vocab), and
    ``use_struct`` (rows, S) bool, true with probability ``p_struct``;
    drawn on ``device`` (default: the CUDA device) from one generator
    seeded from ``(seed, index, shard)``."""
    dev = resolve_device(device)
    key = np.random.SeedSequence([seed, index, shard]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(dev).manual_seed(int(key))
    V, S = spec.vocab_size, spec.seq_len
    first = torch.randint(0, V, (rows, 1), generator=gen, device=dev)
    noise = torch.randint(0, V, (rows, S), generator=gen, device=dev)
    use_struct = torch.rand((rows, S), generator=gen,
                            device=dev) < spec.p_struct
    return first, noise, use_struct


def bigram(spec: LmDatasetSpec, first: torch.Tensor, noise: torch.Tensor,
           use_struct: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels), each (rows, S): ``seq[t] = (a * seq[t-1] + b) mod
    V`` where ``use_struct[:, t]``, else ``noise[:, t]``, from ``seq[-1] =
    first``; tokens are ``first`` followed by ``seq[:-1]``, labels are
    ``seq`` (next-token aligned)."""
    V = spec.vocab_size
    tok = first[:, 0]
    seq = []
    for t in range(noise.shape[1]):
        tok = torch.where(use_struct[:, t], (spec.a * tok + spec.b) % V,
                          noise[:, t])
        seq.append(tok)
    labels = torch.stack(seq, dim=1)
    return torch.cat([first, labels[:, :-1]], dim=1), labels


def batch_at(spec: LmDatasetSpec, seed: int, index: int, batch: int,
             shard: int = 0, n_shards: int = 1, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels) of this shard's ``batch // n_shards`` rows of the
    global batch ``index``, on ``device`` (default: the CUDA device)."""
    assert batch % n_shards == 0
    return bigram(spec, *draws(spec, seed, index, batch // n_shards, shard,
                               device))


def stream(spec: LmDatasetSpec, seed: int, batch: int, start_index: int = 0,
           shard: int = 0, n_shards: int = 1, device=None
           ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`batch_at` of ``start_index``, ``start_index + 1``, ..."""
    dev = resolve_device(device)
    i = start_index
    while True:
        yield batch_at(spec, seed, i, batch, shard, n_shards, dev)
        i += 1
