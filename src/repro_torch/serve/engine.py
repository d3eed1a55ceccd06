"""ServeEngine: batched greedy decode over the KV-segment store (port of
``repro/serve/engine.py``).

Requests take batch slots; ``admit`` prefills a prompt token by token
through ``lm_decode_step`` (one slot's state), ``step`` decodes one token
for every active slot, and each new token's K/V is mirrored into the
``KVSegmentStore`` (float16 on the host), which seals full blocks and
shares identical prefix blocks.  Finished requests release their blocks
and free their slot for the next pending one.

The decode step runs on ``device`` (None: the card), where every GQA
layer's attention is kernel ``decode_attn``; the cache is float32, as in
the reference.  An MLA model's cache is its latent pair (``c_kv``,
``k_rope``), which the store does not hold: as in the reference, its
requests take no blocks and its ``kv_stats`` stay zero.  The step writes
each row's cache entries at that row's own length (see
``models/transformer.py``), so a request outside slot 0 decodes as it
would alone -- the reference writes every row at slot 0's length and gets
such requests wrong.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.transformer import LMConfig, init_kv_cache, lm_decode_step
from repro_torch.serve.kv_segments import KVSegmentStore


@dataclasses.dataclass
class Request:
    rid: str
    prompt: np.ndarray  # (S,)
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Static-batch decode engine (batch slots, continuous refill)."""

    def __init__(
        self,
        params,
        cfg: LMConfig,
        batch_slots: int = 8,
        max_len: int = 512,
        heap_path: Optional[str] = None,
        device=None,
    ) -> None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if params["embed"].device != self.device:
            raise ValueError(f"parameters on {params['embed'].device}, engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.batch = batch_slots
        self.max_len = max_len
        self.cache = init_kv_cache(cfg, batch_slots, max_len, dtype=torch.float32,
                                   device=self.device)
        self.kv_len = np.zeros(batch_slots, np.int32)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.store = KVSegmentStore(
            cfg.n_layers,
            cfg.n_kv_heads,
            cfg.head_dim,
            block_size=64,
            heap_path=heap_path,
        )
        #: whether the store mirrors the cache (not an MLA model's latent pair)
        self.mirrors = cfg.attn != "mla"
        self.completed: List[Request] = []
        #: lm_decode_step calls so far (prefill and decode)
        self.decode_calls = 0

    def _decode(self, toks: np.ndarray):
        """One ``lm_decode_step`` over every slot at the current lengths
        (copied to the device: ``kv_len`` is mutated after the call)."""
        self.decode_calls += 1
        logits, self.cache = lm_decode_step(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.kv_len.copy()).to(self.device), self.cfg)
        return logits

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        self.slots[slot] = req
        self.store.new_request(req.rid)
        # prefill token-by-token through the decode path (single-slot state)
        self.kv_len[slot] = 0
        for t in req.prompt:
            self._step_one(slot, int(t))
        return True

    def _newest_kv(self, slots: List[int]):
        """float16 host copies (L, n, Hkv, hd) of the newest token's K and V
        of each slot: one device-to-host copy each."""
        rows = torch.tensor(slots, device=self.device)
        pos = torch.from_numpy(self.kv_len[slots] - 1).to(self.device).long()
        return tuple(self.cache[name][:, rows, pos].to(torch.float16).cpu().numpy()
                     for name in ("k", "v"))

    def _mirror_kv(self, slot: int) -> None:
        """Copy the newest token's K/V into the segment store (seals blocks,
        dedupes shared prefixes)."""
        req = self.slots[slot]
        if req is None or not self.mirrors:
            return
        k_tok, v_tok = self._newest_kv([slot])
        self.store.append(req.rid, k_tok[:, 0], v_tok[:, 0])

    def _step_one(self, slot: int, token: int) -> int:
        toks = np.zeros(self.batch, np.int64)
        toks[slot] = token
        logits = self._decode(toks)
        self.kv_len[slot] += 1
        self._mirror_kv(slot)
        return int(torch.argmax(logits[slot, : self.cfg.vocab]))

    def step(self) -> int:
        """One decode step across active slots; returns #active."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        toks = np.zeros(self.batch, np.int64)
        for i in active:
            req = self.slots[i]
            toks[i] = req.out[-1] if req.out else (req.prompt[-1] if len(req.prompt) else 1)
        logits = self._decode(toks)
        nxt = torch.argmax(logits[:, : self.cfg.vocab], dim=-1).cpu().numpy()
        self.kv_len[active] += 1
        if self.mirrors:
            k_new, v_new = self._newest_kv(active)
        for j, i in enumerate(active):
            req = self.slots[i]
            if self.mirrors:
                self.store.append(req.rid, k_new[:, j], v_new[:, j])
            req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new or self.kv_len[i] >= self.max_len - 1:
                req.done = True
                self.completed.append(req)
                self.store.release(req.rid)
                self.slots[i] = None
                self.kv_len[i] = 0
        return len(active)

    def run(self, requests: List[Request]) -> Dict:
        t0 = time.perf_counter()
        pending = list(requests)
        steps = 0
        while pending or any(s is not None for s in self.slots):
            while pending and self._free_slot() is not None:
                self.admit(pending.pop(0))
            if self.step() == 0 and not pending:
                break
            steps += 1
        wall = time.perf_counter() - t0
        toks = sum(len(r.out) for r in self.completed)
        return {
            "requests": len(self.completed),
            "decode_steps": steps,
            "tokens": toks,
            "wall_s": wall,
            "tok_per_s": toks / max(wall, 1e-9),
            "kv_stats": dict(self.store.stats),
        }
