"""Batched multi-request serving engine: one batch-dim decode over N slots
(the port's ``repro.serving.batched``).

``BatchedServeEngine`` generalizes :class:`repro_torch.serving.engine.ServeEngine`
from one request to ``n_slots`` concurrent requests while keeping its exactness
contract: every slot's token stream is *identical* to what a single-request
engine would produce for the same prompt/doc schedule.

  * one batched decode state (leading batch dim over slots). A lockstep decode
    step advances every *live* slot with a single ``Model.decode_step`` call at
    per-slot absolute positions.
  * per-slot prefill: slot contexts differ in length, so prefill stays per-slot
    and the resulting row is scattered into the batched state.
  * per-slot snapshot/restore. The bundle (state, positions, last logits) is
    never written in place: decode, scatter, commit and restore all build new
    tensors, as the reference's immutable JAX arrays do. A snapshot is
    therefore an O(1) reference to the whole bundle plus the slot's scalars,
    and restore writes back only that slot's row — so a snapshot taken before
    an overlapped step can be restored a ROUND later, after siblings advanced
    or rolled back, and still rewinds exactly one slot to exactly that step.
    The price is a copy of the bundle per decode step, scatter and restore;
    PERF.md records what it costs on the card.
  * slots leave a lockstep ``gen`` when they hit EOS or their own budget; a
    masked merge commits each slot's state as of its *own* last step.
  * slot lifecycle: ``admit(slot, prompt)`` prefills into a free slot,
    ``retire(slot)`` frees it again; ``gen``/``snapshot``/``restore`` operate
    only on active slots.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineStats, _sync


def _tree_map(fn, *trees):
    """fn over matching leaves of (state list, positions, logits) bundles."""
    first = trees[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _set_row(cur: torch.Tensor, b: int, row: torch.Tensor) -> torch.Tensor:
    out = cur.clone()
    out[b] = row
    return out


class BatchedServeEngine:
    """N-slot greedy engine over a Model: batched decode, per-slot lifecycle."""

    def __init__(self, model: Model, params, n_slots: int, *,
                 cache_window: int = 2048, eos_id: int = -1):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.W = cache_window
        self.eos_id = eos_id
        self.stats = EngineStats()
        # per-slot bookkeeping (host side)
        self.tokens: List[List[int]] = [[] for _ in range(n_slots)]
        self.n_prompt = [0] * n_slots
        self.doc: List[Tuple[int, ...]] = [()] * n_slots
        self.active = [False] * n_slots
        # batched device state: (decode state, per-slot positions, last logits)
        self._state = model.init_decode_state(n_slots, self.W, device=self.device)
        self._pos = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._last_logits = torch.zeros((n_slots, model.cfg.vocab_size),
                                        dtype=torch.float32, device=self.device)

    # ---- bundle helpers ---------------------------------------------------------------
    def _bundle(self):
        return (self._state, self._pos, self._last_logits)

    def _set_bundle(self, bundle) -> None:
        self._state, self._pos, self._last_logits = bundle

    # ---- slot lifecycle ---------------------------------------------------------------
    def admit(self, slot: int, prompt: Sequence[int],
              doc: Sequence[int] = ()) -> None:
        """Admit a request into a FREE slot of the live batch; the per-slot
        prefill replaces only row ``slot`` of the batched state."""
        assert not self.active[slot], f"admit into busy slot {slot}"
        self.active[slot] = True
        self.tokens[slot] = list(prompt)
        self.n_prompt[slot] = len(prompt)
        self.doc[slot] = tuple(doc)
        self._prefill_slot(slot)

    def retire(self, slot: int) -> None:
        """Free a finished slot. Its device row stays stale until the next
        admit's prefill replaces it."""
        assert self.active[slot], f"retire of idle slot {slot}"
        self.active[slot] = False
        self.tokens[slot] = []
        self.n_prompt[slot] = 0
        self.doc[slot] = ()

    def start(self, slot: int, prompt: Sequence[int],
              doc: Sequence[int] = ()) -> None:
        """Fixed-group entry point: (re)start a slot — retire-if-busy + admit."""
        if self.active[slot]:
            self.retire(slot)
        self.admit(slot, prompt, doc)

    def _prefill_slot(self, slot: int) -> None:
        t0 = time.perf_counter()
        seq = list(self.doc[slot]) + self.tokens[slot]
        toks = torch.as_tensor(np.asarray(seq, np.int64), device=self.device)[None]
        with torch.no_grad():
            last, state, pos = self.model.prefill(self.params, toks,
                                                  window_cache=self.W)
        self._state = _tree_map(lambda c, r: _set_row(c, slot, r[0]),
                                self._state, state)
        self._pos = _set_row(self._pos, slot, pos)
        self._last_logits = _set_row(self._last_logits, slot, last[0])
        _sync(self.device)
        self.stats.prefill_time += time.perf_counter() - t0
        self.stats.prefills += 1

    def set_doc(self, slot: int, doc: Sequence[int]) -> None:
        """Prepend-replace the slot's retrieved chunk (re-prefill if changed)."""
        doc = tuple(doc)
        if doc == self.doc[slot]:
            return
        self.doc[slot] = doc
        self._prefill_slot(slot)

    # ---- generation -------------------------------------------------------------------
    def _decode(self, state, tok_vec: np.ndarray, pos):
        with torch.no_grad():
            return self.model.decode_step(
                self.params, state, torch.as_tensor(tok_vec, device=self.device),
                pos)

    def _mask(self, slots) -> torch.Tensor:
        mask = np.zeros((self.n_slots,), bool)
        mask[list(slots)] = True
        return torch.as_tensor(mask, device=self.device)

    def gen(self, slots: Sequence[int], ks: Sequence[int]) -> List[List[int]]:
        """Lockstep greedy decode: up to ``ks[i]`` tokens for ``slots[i]`` (each
        slot stops at EOS or its own budget). One batched decode per step.
        Returns the new tokens per requested slot."""
        assert all(self.active[int(b)] for b in slots), \
            f"gen over idle slot(s): {[int(b) for b in slots if not self.active[int(b)]]}"
        t0 = time.perf_counter()
        remaining = {int(b): int(k) for b, k in zip(slots, ks)}
        out = {int(b): [] for b in slots}
        live = [b for b, k in remaining.items() if k > 0]
        committed = self._bundle()
        current = committed
        while live:
            state, pos, logits = current
            next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
            eos_exits, budget_exits = [], []
            tok_vec = np.zeros((self.n_slots,), np.int64)
            for b in live:
                t = int(next_tok[b])
                out[b].append(t)
                self.tokens[b].append(t)
                if t == self.eos_id:
                    eos_exits.append(b)     # EOS: no decode for this token
                    continue
                tok_vec[b] = t
                remaining[b] -= 1
                if remaining[b] <= 0:
                    budget_exits.append(b)  # budget: commit *after* this decode
            if eos_exits:
                committed = self._commit_bundle(current, committed, eos_exits)
                live = [b for b in live if b not in eos_exits]
                if not live:
                    break
            logits2, state2 = self._decode(state, tok_vec, pos)
            pos2 = pos + self._mask(live).to(torch.int32)
            current = (state2, pos2, logits2)
            if budget_exits:
                committed = self._commit_bundle(current, committed, budget_exits)
                live = [b for b in live if b not in budget_exits]
        self._set_bundle(committed)
        _sync(self.device)
        self.stats.decode_time += time.perf_counter() - t0
        self.stats.decodes += sum(len(v) for v in out.values())
        return [out[int(b)] for b in slots]

    def _commit_bundle(self, current, committed, slot_list):
        mask = self._mask(slot_list)
        return _tree_map(
            lambda n, c: torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, c),
            current, committed)

    # ---- per-slot views ---------------------------------------------------------------
    def generated(self, slot: int) -> List[int]:
        return self.tokens[slot][self.n_prompt[slot]:]

    def finished(self, slot: int) -> bool:
        g = self.generated(slot)
        return bool(g) and g[-1] == self.eos_id

    # ---- speculation support ------------------------------------------------------------
    def snapshot(self, slot: int):
        """O(1): references to the bundle (never written in place) + the
        slot's scalars. Sibling rows are ignored on restore, which is why a
        snapshot stays valid across round boundaries."""
        assert self.active[slot], f"snapshot of idle slot {slot}"
        return (len(self.tokens[slot]), self.doc[slot], self._bundle())

    def restore(self, slot: int, snap) -> None:
        """Rewind ``slot`` to a snapshot it took earlier in ITS OWN request
        (any number of gen/set_doc/sibling-ops later). The slot's token list
        must be an extension of the snapshotted one."""
        assert self.active[slot], f"restore of idle slot {slot}"
        n, doc, bundle = snap
        assert n <= len(self.tokens[slot]), \
            f"slot {slot}: snapshot is not from this request's lineage"
        self.tokens[slot] = self.tokens[slot][:n]
        self.doc[slot] = doc
        self._set_bundle(_tree_map(lambda c, o: _set_row(c, slot, o[slot]),
                                   self._bundle(), bundle))
