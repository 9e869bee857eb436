"""Serving engine: prefill + greedy decode with snapshot/rollback (the port's
``repro.serving.engine``).

RaLMSpec needs three properties from the LM side:
  * deterministic generation (greedy) — the output-preservation proof needs it,
  * cheap state snapshots at speculation-step boundaries — the model's decode
    step and prefill build new state tensors and never write into old ones
    (the reference gets this from JAX's immutable arrays), so a snapshot is
    (context length, doc, state *reference*, position, last logits): O(1),
  * doc-conditioned generation à la Ram et al. 2023: the latest retrieved chunk
    is prepended to the prompt, *replacing* the previous one, which invalidates
    the KV cache ⇒ re-prefill. This is the baseline's dominant G-cost.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclass
class EngineStats:
    prefill_time: float = 0.0
    decode_time: float = 0.0
    prefills: int = 0
    decodes: int = 0

    @property
    def gen_time(self) -> float:        # the paper's G component
        return self.prefill_time + self.decode_time

    def reset(self):
        self.prefill_time = self.decode_time = 0.0
        self.prefills = self.decodes = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Single-request greedy engine over a Model. ``device`` is where the
    parameters live (the engine reads it from them)."""

    def __init__(self, model: Model, params, *, cache_window: int = 2048,
                 eos_id: int = -1):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.W = cache_window
        self.eos_id = eos_id
        self.stats = EngineStats()
        # mutable per-request state
        self.doc: Tuple[int, ...] = ()
        self.tokens: List[int] = []        # prompt + generated (doc NOT included)
        self.n_prompt = 0
        self._state = None
        self._pos = 0
        self._last_logits = None

    # ---- request lifecycle -----------------------------------------------------------
    def start(self, prompt: Sequence[int], doc: Sequence[int] = ()) -> None:
        self.tokens = list(prompt)
        self.n_prompt = len(prompt)
        self.doc = tuple(doc)
        self._prefill()

    def _prefill(self) -> None:
        t0 = time.perf_counter()
        seq = list(self.doc) + self.tokens
        toks = torch.as_tensor(np.asarray(seq, np.int64), device=self.device)[None]
        with torch.no_grad():
            last, state, pos = self.model.prefill(self.params, toks,
                                                  window_cache=self.W)
        self._last_logits = last
        self._state = state
        self._pos = pos
        _sync(self.device)
        self.stats.prefill_time += time.perf_counter() - t0
        self.stats.prefills += 1

    def set_doc(self, doc: Sequence[int]) -> None:
        """Prepend-replace the retrieved chunk (re-prefill if it changed)."""
        doc = tuple(doc)
        if doc == self.doc:
            return
        self.doc = doc
        self._prefill()

    def _step(self, tok: int) -> None:
        with torch.no_grad():
            logits, self._state = self.model.decode_step(
                self.params, self._state,
                torch.tensor([tok], device=self.device), self._pos)
        self._pos += 1
        self._last_logits = logits

    # ---- generation -------------------------------------------------------------------
    def gen(self, k: int) -> List[int]:
        """Greedy-decode up to k tokens (stops at EOS). Returns the new tokens."""
        t0 = time.perf_counter()
        out = []
        for _ in range(k):
            tok = int(torch.argmax(self._last_logits[0]))
            out.append(tok)
            self.tokens.append(tok)
            if tok == self.eos_id:
                break
            self._step(tok)
        _sync(self.device)
        self.stats.decode_time += time.perf_counter() - t0
        self.stats.decodes += len(out)
        return out

    def peek_logits(self) -> np.ndarray:
        """Logits for the *next* token given the current context (KNN-LM interp)."""
        return self._last_logits[0].cpu().numpy()

    def advance(self, tok: int) -> None:
        """Append an externally-chosen token (KNN-LM: interpolated argmax)."""
        t0 = time.perf_counter()
        self.tokens.append(int(tok))
        self._step(int(tok))
        _sync(self.device)
        self.stats.decode_time += time.perf_counter() - t0
        self.stats.decodes += 1

    @property
    def generated(self) -> List[int]:
        return self.tokens[self.n_prompt:]

    @property
    def finished(self) -> bool:
        return bool(self.generated) and self.generated[-1] == self.eos_id

    # ---- speculation support ------------------------------------------------------------
    def snapshot(self):
        """O(1): references to state tensors that nothing writes into again."""
        return (len(self.tokens), self.doc, self._state, self._pos,
                self._last_logits)

    def restore(self, snap) -> None:
        n, doc, state, pos, last = snap
        self.tokens = self.tokens[:n]
        self.doc = doc
        self._state = state
        self._pos = pos
        self._last_logits = last
