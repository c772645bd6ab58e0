"""Batched LM serving engine: slot-based continuous batching over the
decode caches, counterpart of ``repro.serve.engine``.

The engine owns a fixed batch of **slots**.  A request is admitted into a
free slot: its prompt is prefilled alone (B = 1) and the resulting caches
are written into the slot's rows of every cache leaf.  Then all slots
advance together through one batched :func:`decode_step`, each at its
own position; finished slots (EOS, ``max_tokens``, or the cache full at
``pos >= S - 1``) are released and refilled without stopping the batch.
A decode step reads one thing back to the host: the step's logits.

The engine serves every decoder-only architecture (attention, RG-LRU,
mLSTM / sLSTM, dense and MoE FFNs): each cache leaf, the recurrent
blocks' float32 states included, is written row by row as it is.  Like
the reference's, it passes no stub inputs, so it refuses a config with an
encoder or a frontend (whisper, internvl2); ``transformer.prefill(frames=
..., patches=...)`` and ``decode_step`` run those.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves


@dataclasses.dataclass
class Request:
    """One generation request: prompt in, sampled tokens accumulated."""

    uid: int
    prompt: np.ndarray              # (P,) int
    max_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy or temperature sampling over a slot batch.

    ``params`` live on ``device`` (default: the CUDA device, raising
    without one).  Temperature sampling takes ``argmax(logits / T + g)``
    with Gumbel noise ``g`` from :meth:`gumbel` (the engine's own
    ``torch.Generator``, seeded by ``seed``), which is what
    ``jax.random.categorical`` computes; a test may replace
    :meth:`gumbel` to pass the noise in.
    """

    def __init__(self, cfg: ModelConfig, params: Any, batch_slots: int,
                 cache_len: int, eos_id: int = 1,
                 temperature: float = 0.0, seed: int = 0, device=None):
        if cfg.encoder is not None or cfg.frontend is not None:
            raise ValueError(
                f"{cfg.name}: the engine passes no frames or patches; run "
                f"an encoder or frontend config through transformer."
                f"prefill(frames=/patches=) and decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.S = cache_len
        self.eos = eos_id
        self.temperature = temperature
        self.generator = torch.Generator().manual_seed(seed)

        self.cache = T.init_cache(cfg, batch_slots, cache_len, self.device)
        self.pos = np.zeros((batch_slots,), np.int64)       # next position
        self.active = np.zeros((batch_slots,), bool)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.last_token = np.zeros((batch_slots,), np.int64)
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "generated": 0}

    # --- device side -------------------------------------------------------

    def _prefill(self, tokens: torch.Tensor):
        logits, cache, _ = T.prefill(self.params, self.cfg, tokens,
                                     cache_len=self.S)
        return logits[:, -1, :], cache

    def _decode(self, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """Batched decode over every slot, each at its own position;
        inactive slots compute rows that the host ignores."""
        logits, cache, _ = T.decode_step(self.params, self.cfg, cache,
                                         tokens[:, None], pos)
        return logits[:, 0, :], cache

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        """The real vocabulary's logits as float32 on the host (the one
        device read of a step)."""
        return logits[:, :self.cfg.vocab_size].float().cpu().numpy()

    # --- host API ----------------------------------------------------------

    def try_admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False when all slots busy."""
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            return False
        P = len(req.prompt)
        if P > self.S - 1:
            raise ValueError(f"request {req.uid}: a prompt of {P} tokens "
                             f"leaves no room in a cache of {self.S}")
        slot = int(free[0])
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)
                                 ).to(self.device)[None, :]
        logits, cache1 = self._prefill(tokens)
        # copy the single-row caches into this slot's rows
        for (_, dst), (_, src) in zip(tree_leaves(self.cache),
                                      tree_leaves(cache1)):
            dst[slot:slot + 1].copy_(src)
        tok = self._sample(self._host_logits(logits)[0])
        self.slot_req[slot] = req
        self.active[slot] = True
        self.pos[slot] = P
        self.last_token[slot] = tok
        req.out_tokens.append(int(tok))
        self.stats["prefill_tokens"] += P
        return True

    def gumbel(self, shape) -> np.ndarray:
        """Standard Gumbel noise, float32, from the engine's generator."""
        u = torch.rand(shape, generator=self.generator)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).numpy()

    def _sample(self, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        return int(np.argmax(logits / np.float32(self.temperature)
                             + self.gumbel(logits.shape)))

    def step(self) -> int:
        """One decode step for every active slot; returns #active."""
        n_active = int(self.active.sum())
        if n_active == 0:
            return 0
        logits, self.cache = self._decode(
            self.cache, torch.as_tensor(self.last_token).to(self.device),
            torch.as_tensor(self.pos).to(self.device))
        logits = self._host_logits(logits)
        self.stats["decode_steps"] += 1
        for slot in np.nonzero(self.active)[0]:
            req = self.slot_req[slot]
            tok = self._sample(logits[slot])
            req.out_tokens.append(tok)
            self.pos[slot] += 1
            self.last_token[slot] = tok
            self.stats["generated"] += 1
            if tok == self.eos or len(req.out_tokens) >= req.max_tokens \
                    or self.pos[slot] >= self.S - 1:
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
        return n_active

    def run(self, requests: List[Request], max_steps: int = 10_000) -> None:
        """Continuous batching: admit as slots free, decode until drained."""
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            if self.step() == 0 and not pending:
                break
