"""Continuous-batching serving engine (``repro/serve/engine.py``).

Slot model: a fixed grid of ``n_slots`` request slots shares one batched
cache.  Admission prefills one request (at a bucketed length, or at its
exact length for the ssm and hybrid families, whose recurrent state
padding would corrupt) into a one-request cache and copies it into the
request's slot of every cache leaf, the conv and SSM state included, so a
readmitted slot carries nothing of its last request.  Decode advances
*all* slots with one step per token; inactive slots compute values that
nobody reads.  Freed slots readmit from the queue at once.

The engine runs on one device (``repro_torch.device``): the card unless
``device="cpu"``; without a card and without ``device=`` it raises.  Its
cache is updated in place.  Its requests carry tokens only, as the
reference's do, so it refuses the families that need a context stream
(vlm, encdec): they run through ``Model.prefill`` with their
``image_embeds`` or ``frames`` and ``Model.decode_step``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import tree_map

from .sampling import sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Engine:
    """``Engine(model, params=None, ..., device=None)``.  ``params`` are
    loaded onto the device in the compute dtype once (``Model.load``);
    without them the engine draws the model's parameters from a generator
    seeded with ``seed``.  Sampling draws from a generator seeded with
    ``seed`` on the device."""

    def __init__(self, model, params: Any = None, *, n_slots: int = 4,
                 max_len: int = 256, ring: bool = False,
                 prefill_buckets: tuple[int, ...] = (16, 32, 64, 128),
                 seed: int = 0, device=None):
        if model.cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                f"the engine's requests carry tokens only; {model.cfg.name} "
                f"({model.cfg.family}) needs a context stream: call "
                "Model.prefill with its inputs, then Model.decode_step")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model was built for {model.device}; the "
                             f"engine runs on {self.device}")
        self.model = model
        if params is None:
            params = model.init(torch.Generator(self.device).manual_seed(seed))
        self.params = model.load(params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.ring = ring
        self.buckets = prefill_buckets
        self.cache = model.init_cache(n_slots, max_len, ring=ring)
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)       # next position to write
        self.last_token = np.zeros(n_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.steps = 0

    # --- request lifecycle -------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            self._prefill_into(slot, self.queue.popleft())

    def _prefill_into(self, slot: int, req: Request) -> None:
        """Admit one request: prefill its first n-1 tokens, then schedule
        the n-th through the shared decode step.

        Bucketed prefill pads with zeros; causal masking keeps the pad
        region ([n-1, L)) unread until decode overwrites it slot by slot.
        """
        n = len(req.prompt)
        exact = self.model.cfg.family in ("ssm", "hybrid")
        if n > 1:
            L = (n - 1) if exact else _bucket(n - 1, self.buckets)
            toks = np.zeros((1, L), np.int32)
            toks[0, : n - 1] = req.prompt[: n - 1]
            one_cache = self.model.init_cache(1, self.max_len, ring=self.ring)
            positions = torch.arange(L, device=self.device)[None]
            _, one_cache = self.model.prefill(
                self.params,
                {"tokens": torch.from_numpy(toks).to(self.device)},
                one_cache, positions=positions)
            tree_map(lambda big, one: big[:, slot].copy_(one[:, 0]),
                     self.cache, one_cache)
        self.slots[slot] = req
        self.pos[slot] = n - 1           # next decode consumes prompt[n-1]
        self.last_token[slot] = req.prompt[n - 1]

    # --- decode ---------------------------------------------------------
    def step(self) -> None:
        """Admit pending requests, then advance every active slot one token."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return
        toks = torch.from_numpy(self.last_token).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = self.model.decode_step(
            self.params, toks, self.cache, pos, ring=self.ring)
        temps = [s.temperature if s else 0.0 for s in self.slots]
        # one sample call for the grid, at the first slot's temperature
        nxt = sample(self.generator, logits, temperature=temps[0]).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            tok = int(nxt[i])
            self.last_token[i] = tok
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos or \
                    int(self.pos[i]) >= self.max_len - 1:
                req.done = True
                self.slots[i] = None
        self.steps += 1

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until queue and slots drain."""
        while (self.queue or any(self.slots)) and max_steps > 0:
            self.step()
            max_steps -= 1

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)
