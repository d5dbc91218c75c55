"""Batched serving engine: request queue -> prefill -> interleaved decode.

Port of ``repro.serving.engine``. A deliberately small continuous-batching
core (the vLLM pattern at framework scale): fixed decode slots, each slot
holds one sequence's cache row; finished sequences free their slot for the
next queued request. Prefill runs per-request (cache rows are written into
the slot), decode runs as one batched ``decode_step`` over all active
slots.

As in the reference, one engine step decodes every slot at the largest
position among the active slots (grouping slots by position is the
production path; the demo steps the max).

The engine runs on ``device`` (the card when None); the params must
already live there.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,)
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, slots: int = 4,
                 cache_len: int = 256, *, device=None):
        assert not cfg.frontend, "engine demo uses token-input archs"
        self.device = M.resolve_device(device, "ServingEngine")
        where = {leaf.device for leaf in M.tree_leaves(params)}
        if any(d.type != self.device.type for d in where):
            raise ValueError(f"the params live on {sorted(map(str, where))}"
                             f", the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.cache = M.zeros_cache(M.cache_spec(cfg, slots, cache_len, tp=1),
                                   self.device)
        self.active: list[Request | None] = [None] * slots
        self.pos = np.zeros(slots, np.int32)
        self.queue: deque[Request] = deque()

    # --- request management -------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.popleft()
                self._prefill_into_slot(i, req)

    def _prefill_into_slot(self, slot: int, req: Request):
        toks = torch.as_tensor(np.asarray(req.tokens),
                               device=self.device)[None, :]
        logits, cache1 = M.prefill(self.params, {"tokens": toks}, self.cfg,
                                   cache_len=self.cache_len, q_chunk=64,
                                   kv_chunk=64)
        first = int(torch.argmax(logits[0, -1, : self.cfg.vocab]))
        req.out.append(first)
        for name in M.FIELDS:
            full = getattr(self.cache, name)
            if full is not None:
                full[:, slot: slot + 1] = getattr(cache1, name)
        self.active[slot] = req
        self.pos[slot] = len(req.tokens)

    # --- one engine step ------------------------------------------------------

    def step(self):
        """Admit queued requests, then one batched decode over active slots."""
        self._admit()
        if not any(self.active):
            return False
        # uniform pos per decode_step call: group slots by position is the
        # production path; the demo steps the max and masks finished rows.
        last = [r.out[-1] if r else 0 for r in self.active]
        toks = torch.as_tensor(last, dtype=torch.int32,
                               device=self.device)[:, None]
        pos = int(max(self.pos[i] for i, r in enumerate(self.active) if r))
        logits, self.cache = M.decode_step(self.params, self.cache,
                                           {"tokens": toks}, pos, self.cfg)
        nxt = torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1).cpu()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[i]))
            self.pos[i] += 1
            if len(req.out) >= req.max_new \
                    or self.pos[i] >= self.cache_len - 1:
                req.done = True
                self.active[i] = None
        return True

    def run(self, max_steps: int = 256) -> list[Request]:
        finished: list[Request] = []
        seen: set[int] = set()
        all_reqs: list[Request] = list(self.queue)
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        for r in all_reqs:
            if r.done and r.rid not in seen:
                finished.append(r)
                seen.add(r.rid)
        return finished
