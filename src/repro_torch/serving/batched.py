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
    The price is a copy of the bundle per decode step (on the card, the
    clone of a graph replay's output: ``Model.decode_step``), scatter and
    restore; PERF.md records what it costs on the card. A leaf that a step
    hands on as it is (an audio decoder's cross K/V) is neither copied by a
    commit nor by a restore that finds the same tensor.
  * slots leave a lockstep ``gen`` when they hit EOS or their own budget; a
    masked merge commits each slot's state as of its *own* last step (a
    merge over every slot is the stepped bundle itself).
  * slot lifecycle: ``admit(slot, prompt)`` prefills into a free slot,
    ``retire(slot)`` frees it again; ``gen``/``advance``/``snapshot``/
    ``restore`` operate only on active slots. The continuous scheduler
    (``serving/continuous.py``) drives this API to admit queued requests
    mid-flight.
  * KNN-LM hooks: ``peek_logits(slot)`` reads a slot's next-token logits and
    ``advance(slots, toks)`` decodes externally chosen tokens in one step.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.models.model import Model
from repro_torch.serving.engine import EngineStats, _sync
from repro_torch.tree import tree_map


def _set_row(cur: torch.Tensor, b: int, row: torch.Tensor) -> torch.Tensor:
    out = cur.clone()
    out[b] = row
    return out


class BatchedServeEngine:
    """N-slot greedy engine over a Model: batched decode, per-slot lifecycle.
    ``extra`` goes to every per-slot prefill, as in ``ServeEngine``."""

    def __init__(self, model: Model, params, n_slots: int, *,
                 cache_window: int = 2048, eos_id: int = -1,
                 extra: Optional[dict] = None):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.W = cache_window
        self.eos_id = eos_id
        self.extra = extra
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

    def warm(self, lengths: Sequence[int]) -> None:
        """One per-slot prefill at each context length in ``lengths`` and one
        batched decode step over the live bundle, as the reference's ``warm``:
        a timed run that follows pays for no kernel build, no allocator growth
        and, on the card, no capture of the decode step's CUDA graph (the
        first step of a key captures it: ``Model.decode_step``). Nothing is
        scattered or committed, so every slot, snapshot and stat stays as it
        was."""
        with torch.no_grad():
            for n in sorted(set(int(x) for x in lengths)):
                toks = torch.zeros((1, n), dtype=torch.long, device=self.device)
                self.model.prefill(self.params, toks, extra=self.extra,
                                   window_cache=self.W)
            self.model.decode_step(self.params, self._state,
                                   torch.zeros((self.n_slots,), dtype=torch.long,
                                               device=self.device), self._pos)
        _sync(self.device)

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

    def free_slots(self) -> List[int]:
        return [b for b in range(self.n_slots) if not self.active[b]]

    def start(self, slot: int, prompt: Sequence[int],
              doc: Sequence[int] = ()) -> None:
        """Fixed-group entry point: (re)start a slot — retire-if-busy + admit."""
        if self.active[slot]:
            self.retire(slot)
        self.admit(slot, prompt, doc)

    def _prefill_slot(self, slot: int) -> None:
        t0 = time.perf_counter()
        seq = list(self.doc[slot]) + self.tokens[slot]
        with trace.span("engine.prefill", slot=slot, tokens=len(seq)):
            with trace.span("engine.prefill.dispatch"):
                toks = torch.as_tensor(np.asarray(seq, np.int64), device=self.device)[None]
                with torch.no_grad():
                    last, state, pos = self.model.prefill(self.params, toks, extra=self.extra,
                                                          window_cache=self.W)
                self._state = tree_map(lambda c, r: _set_row(c, slot, r[0]),
                                        self._state, state)
                self._pos = _set_row(self._pos, slot, pos)
                self._last_logits = _set_row(self._last_logits, slot, last[0])
            with trace.span("engine.sync"):
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
    def _decode(self, state, tok_vec: np.ndarray, pos, span=trace.OFF):
        """One lockstep step. While ``span`` (the step's ``engine.dispatch``)
        records, it gets ``graph`` 1 where the step replayed a CUDA graph and
        ``copied`` 1 where that replay copied state in (``DecodeGraph``)."""
        on = span is not trace.OFF
        g = self.model.decode_graph(self.params, state) if on else None
        r0, c0 = (g.replays, g.copies) if g else (0, 0)
        with torch.no_grad():
            out = self.model.decode_step(
                self.params, state, torch.as_tensor(tok_vec, device=self.device),
                pos)
        if on:              # a graph made by this call captured it: the step ran eagerly
            r1, c1 = (g.replays, g.copies) if g else (0, 0)
            span.set(graph=int(r1 > r0), copied=int(c1 > c0))
        return out

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
        with trace.span("engine.decode", slots=len(live)):
            while live:
                state, pos, logits = current
                with trace.span("engine.readback"):
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
                    with trace.span("engine.commit", slots=len(eos_exits)):
                        committed = self._commit_bundle(current, committed, eos_exits)
                    live = [b for b in live if b not in eos_exits]
                    if not live:
                        break
                with trace.span("engine.dispatch", live=len(live)) as sp:
                    logits2, state2 = self._decode(state, tok_vec, pos, sp)
                    pos2 = pos + self._mask(live).to(torch.int32)
                current = (state2, pos2, logits2)
                if budget_exits:
                    with trace.span("engine.commit", slots=len(budget_exits)):
                        committed = self._commit_bundle(current, committed, budget_exits)
                    live = [b for b in live if b not in budget_exits]
            self._set_bundle(committed)
            with trace.span("engine.sync"):
                _sync(self.device)
        self.stats.decode_time += time.perf_counter() - t0
        self.stats.decodes += sum(len(v) for v in out.values())
        return [out[int(b)] for b in slots]

    def _commit_bundle(self, current, committed, slot_list):
        """``current``'s rows for the slots in ``slot_list``, ``committed``'s
        for the others. Over every slot that is ``current`` itself: a
        ``where`` over an all-true mask would copy it bit for bit, and the
        state a graphed step returned would no longer be the one its graph
        holds, so the next step would copy it back in (``DecodeGraph``)."""
        if len(set(slot_list)) == self.n_slots:
            return current
        mask = self._mask(slot_list)
        return tree_map(
            lambda n, c: c if n is c else
            torch.where(mask.reshape((-1,) + (1,) * (n.ndim - 1)), n, c),
            current, committed)

    def peek_logits(self, slot: int) -> np.ndarray:
        """Logits for the slot's *next* token given its current context —
        the batched form of ServeEngine.peek_logits (KNN-LM interpolation).
        One (vocab,) copy to the host per call."""
        assert self.active[slot], f"peek_logits of idle slot {slot}"
        with trace.span("knn.peek", slot=slot):
            return self._last_logits[slot].cpu().numpy()

    def advance(self, slots: Sequence[int], toks: Sequence[int]) -> None:
        """Append one externally-chosen token per given slot (KNN-LM: the
        interpolated argmax) and run ONE batched decode step over exactly
        those slots — the lockstep form of ServeEngine.advance. As in
        ``gen``, the step builds a new bundle and the masked commit keeps the
        old rows of the slots not in ``slots`` (decoded with a dummy token
        and discarded), so nothing a snapshot holds is written."""
        slots = [int(b) for b in slots]
        assert all(self.active[b] for b in slots), \
            f"advance over idle slot(s): {[b for b in slots if not self.active[b]]}"
        t0 = time.perf_counter()
        committed = self._bundle()
        state, pos, _ = committed
        tok_vec = np.zeros((self.n_slots,), np.int64)
        for b, t in zip(slots, toks):
            t = int(t)
            self.tokens[b].append(t)
            tok_vec[b] = t
        with trace.span("engine.decode", slots=len(slots)):
            with trace.span("engine.dispatch", live=len(slots)) as sp:
                logits2, state2 = self._decode(state, tok_vec, pos, sp)
                pos2 = pos + self._mask(slots).to(torch.int32)
            with trace.span("engine.commit", slots=len(slots)):
                self._set_bundle(self._commit_bundle((state2, pos2, logits2), committed,
                                                     slots))
            with trace.span("engine.sync"):
                _sync(self.device)
        self.stats.decode_time += time.perf_counter() - t0
        self.stats.decodes += len(slots)

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
        with trace.span("engine.restore", slot=slot):
            self._set_bundle(tree_map(lambda c, o: c if c is o else _set_row(c, slot, o[slot]),
                                       self._bundle(), bundle))
