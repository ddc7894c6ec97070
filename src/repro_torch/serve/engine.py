"""Batched LM serving engine: continuous batching over a fixed-capacity slot
pool, prefill + decode steps, greedy/temperature sampling.

Port of ``repro.serve.engine`` for every token model: the
attention-block families (dense and moe, ``AttnLM``), the hybrid
(``HybridLM``) and rwkv6 (``RwkvLM``).  vlm and audio configs embed no tokens and are rejected,
as in the reference.  Slot refill order, the last prompt token feeding
the first decode step and the ``max_len`` stop are the reference's.
Filling a slot differs, to keep the reference's own contract that a
request joining mid-stream does not change another's output
(``tests/test_serve.py:46``):

  * the reference fills a slot by running full-batch decode steps over the
    prompt; on the hybrid and rwkv6 that also advances the recurrent state
    of every other slot, and it never clears a refilled slot's state;
  * here the slot's state is zeroed, ``prompt[:-1]`` is prefilled through
    the model's ``prefill`` at batch 1 (``transformer.prefill_len``: the
    longest prefix prefill accepts; for rwkv6 the longest multiple of 64,
    its chunked form) and written into that slot's rows, and any remainder
    is decoded token by token over a view of that slot's rows alone.

The reference's decode-step fill never drops a MoE token (decode runs at
capacity factor ``E / k``), but a prefill at the config's capacity factor
(1.25 at full width) would.  So the engine prefills MoE models at
``E / k`` too: a served request's tokens are ``forward``'s drop-free
argmax chain, whatever else the batch holds.

Every decode step runs all slots (idle ones too, at a clamped position),
so the batch shape, and with it the arithmetic of each row, does not depend
on which other slots are busy.  Sampling at ``temperature > 0`` draws from
a seeded ``torch.Generator``; its draws are not JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _slot_rows(cache: T.Tree, slot: int) -> T.Tree:
    """Views of one slot's rows of every cache leaf (batch of 1)."""
    return {name: {k: t.narrow(T.BATCH_AXIS[name], slot, 1)
                   for k, t in leaves.items()}
            for name, leaves in cache.items()}


class ServeEngine:
    """Slot-based continuous batching.

    Capacity = ``slots`` concurrent sequences with a shared ``max_len`` KV
    budget.  Each engine step decodes one token for every active slot;
    finished slots are refilled from the queue (prefill) before the next
    decode.  Runs on ``device`` (default the card; with no card that
    raises), where ``model`` must already live.
    """

    def __init__(self, cfg: ArchConfig, model: T.LM, *, slots: int,
                 max_len: int, seed: int = 0, device: DeviceSpec = None):
        if not cfg.embed_inputs:
            raise ValueError("serving engine drives token models "
                             "(cfg.embed_inputs must be set)")
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, the engine "
                             f"serves on {self.device}")
        self.cfg, self.model = cfg, model
        self.slots, self.max_len = slots, max_len
        self.cache = model.init_cache(slots, max_len)
        self.position = np.zeros((slots,), np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.last_token = np.zeros((slots,), np.int64)
        self.prefill_kw = {} if cfg.moe is None else \
            {"capacity_factor": MOE.drop_free_factor(cfg.moe)}

    def submit(self, req: Request) -> None:
        if not req.prompt or len(req.prompt) > self.max_len:
            raise ValueError(f"request {req.rid}: prompt of {len(req.prompt)} "
                             f"tokens, need 1..{self.max_len}")
        self.queue.append(req)

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64),
                               device=self.device)

    @torch.no_grad()
    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Zero the slot's state, prefill ``prompt[:-1]`` into it at batch 1
        (drop-free for MoE) and decode any remainder over the slot's rows
        alone; the final prompt token is consumed by the first engine
        decode step (whose logits produce ``out[0]``)."""
        rows = _slot_rows(self.cache, slot)
        for leaves in rows.values():
            for t in leaves.values():
                t.zero_()
        body = req.prompt[:-1]
        n = T.prefill_len(self.cfg, len(body))
        if n:
            _, pre = self.model.prefill(tokens=self._tensor([body[:n]]),
                                        **self.prefill_kw)
            for name, leaves in pre.items():
                for k, t in leaves.items():
                    dst = rows[name][k]
                    if name == "kv":
                        dst = dst.narrow(2, 0, n)
                    dst.copy_(t)
        for pos in range(n, len(body)):
            self.model.decode_step(rows, self._tensor([pos]),
                                   tokens=self._tensor([[body[pos]]]))
        self.position[slot] = len(body)
        self.active[slot] = req
        self.last_token[slot] = req.prompt[-1]

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration; returns the number of active slots."""
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                self._prefill_into_slot(slot, self.queue.pop(0))
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        # idle slots decode too (same batch shape every step), at a position
        # inside the cache; their rows are zeroed when they are filled
        pos = np.minimum(self.position, self.max_len - 1)
        logits, _ = self.model.decode_step(
            self.cache, self._tensor(pos),
            tokens=self._tensor(self.last_token[:, None]))
        greedy = torch.argmax(logits[:, -1], dim=-1).tolist()
        for slot in live:
            req = self.active[slot]
            nxt = greedy[slot] if req.temperature <= 0 else \
                self._sample(logits[slot, -1], req.temperature)
            req.out.append(nxt)
            self.last_token[slot] = nxt
            self.position[slot] += 1
            if len(req.out) >= req.max_new or \
                    self.position[slot] >= self.max_len:
                req.done = True
                self.active[slot] = None
        return len(live)

    def run(self) -> None:
        while self.queue or any(a is not None for a in self.active):
            self.step()
