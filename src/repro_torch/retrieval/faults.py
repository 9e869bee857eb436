"""Fault injection for the retrieval path (chaos harness) + the exception
taxonomy the serving layer's fault-tolerance shell is written against (the
port's ``repro.retrieval.faults``).

The serving stack's preservation story (byte-identical outputs to RaLMSeq)
rests on the KB verification call being *authoritative* — which is what makes
transient-fault recovery free: KB search is a pure function of the query, so
a retried call returns byte-identical rows, and any schedule of transient
faults on the merged verification call leaves fleet outputs untouched. This
module supplies the faults; ``repro_torch.core.ralmspec._ServerBase.
_retrieve_guarded`` supplies the retry/deadline shell;
``repro_torch.serving.fleet`` degrades gracefully when the budget runs out.

Determinism: the injector draws its fault schedule from a seeded
``numpy.random.Generator``, two uniforms per call *unconditionally*, so the
schedule is a pure function of (seed, call index) — independent of the
configured rates, identical across two runs with the same seed, and equal to
the reference's for the same spec. Explicit per-call-index injection
(``error_calls`` / ``spike_calls``) composes with the probabilistic rates.

Wrappers, not subclasses: :class:`FaultyBackend` decorates any
``repro_torch.retrieval.backends`` backend (EDR's ``search``, ADR's
``search_gathered``; the CUDA kernel backends included), :class:`FaultyKB`
decorates a ``SparseKB`` (BM25's full-corpus ``score``). Everything else
delegates to the wrapped object, so the wrapped stack is indistinguishable
until a fault fires.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np


class TransientRetrievalError(RuntimeError):
    """A retrieval call failed in a way a retry may fix (the injected fault
    kind; real deployments map network/RPC errors here)."""


class RetrievalTimeout(RuntimeError):
    """A retrieval call overran the per-call deadline
    (``RaLMConfig.retrieval_timeout_s``); its rows were discarded."""


class RetrievalFailed(RuntimeError):
    """A retrieval call failed after exhausting the retry budget — the
    serving layer degrades the round (or re-raises when
    ``rcfg.degrade_on_failure`` is off)."""


@dataclass(frozen=True)
class FaultSpec:
    """One seeded fault schedule (see `parse_fault_spec` for the CLI DSL).

    ``p_error`` / ``p_spike`` are per-call probabilities of raising
    :class:`TransientRetrievalError` / sleeping ``spike_s`` seconds before
    the real scan (a spike turns into a timeout when it pushes the call past
    the serving layer's deadline). ``error_calls`` / ``spike_calls`` force a
    fault at explicit 0-based call indices regardless of the draw.
    ``max_faults`` caps the total injected faults (-1 = unlimited) — chaos
    tests use it to make an outage provably transient."""

    seed: int = 0
    p_error: float = 0.0
    p_spike: float = 0.0
    spike_s: float = 0.0
    error_calls: Tuple[int, ...] = ()
    spike_calls: Tuple[int, ...] = ()
    max_faults: int = -1


_FLOAT_KEYS = ("p_error", "p_spike", "spike_s")
_INT_KEYS = ("seed", "max_faults")
_CALL_KEYS = ("error_calls", "spike_calls")


def parse_fault_spec(text: str) -> FaultSpec:
    """Parse the ``--inject-faults`` DSL: comma-separated ``key=value`` with
    keys from :class:`FaultSpec` (call lists are ``;``-separated, e.g.
    ``p_error=0.2,spike_s=0.05,p_spike=0.1,seed=3,error_calls=1;4``).
    Raises ``ValueError`` with a one-line message — the serve CLI maps it to
    an argparse error instead of a traceback."""
    kw = {}
    known = ", ".join(_FLOAT_KEYS + _INT_KEYS + _CALL_KEYS)
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad fault field {part!r} (want key=value; "
                             f"known keys: {known})")
        key, val = part.split("=", 1)
        key = key.strip().replace("-", "_")
        try:
            if key in _FLOAT_KEYS:
                kw[key] = float(val)
            elif key in _INT_KEYS:
                kw[key] = int(val)
            elif key in _CALL_KEYS:
                kw[key] = tuple(int(x) for x in val.split(";") if x.strip())
            else:
                raise ValueError
        except ValueError:
            raise ValueError(f"bad fault field {part!r} (known keys: "
                             f"{known})") from None
    spec = FaultSpec(**kw)
    if not (0.0 <= spec.p_error <= 1.0 and 0.0 <= spec.p_spike <= 1.0):
        raise ValueError("fault probabilities must be in [0, 1]")
    if spec.spike_s < 0:
        raise ValueError("spike_s must be >= 0")
    return spec


class FaultInjector:
    """The seeded schedule executor shared by a stack's fault wrappers.

    ``fire()`` is called once per wrapped KB scan; it decides error / spike /
    clean from the (seed, call index) draw, logs the decision, then acts.
    Thread-safe: the async fleet's verification worker and the main thread
    both reach the wrapped backend (calls are serialized by the serving
    design, but the injector does not rely on that)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._rng = np.random.default_rng(spec.seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.errors = 0
        self.spikes = 0
        self.log: List[Tuple[int, str]] = []   # (call index, 'ok'|'error'|'spike')

    @property
    def injected(self) -> int:
        return self.errors + self.spikes

    def fire(self) -> None:
        spec = self.spec
        with self._lock:
            i, self.calls = self.calls, self.calls + 1
            # draw both uniforms unconditionally: the schedule is a pure
            # function of (seed, call index), whatever the rates are
            u_err, u_spike = self._rng.random(2)
            kind = "ok"
            if spec.max_faults < 0 or self.injected < spec.max_faults:
                if i in spec.error_calls or u_err < spec.p_error:
                    kind = "error"
                    self.errors += 1
                elif i in spec.spike_calls or u_spike < spec.p_spike:
                    kind = "spike"
                    self.spikes += 1
            self.log.append((i, kind))
        if kind == "spike":
            time.sleep(spec.spike_s)
        elif kind == "error":
            raise TransientRetrievalError(f"injected fault at KB call {i}")


Faults = Union[FaultSpec, FaultInjector]


def _injector(faults: Faults) -> FaultInjector:
    return faults if isinstance(faults, FaultInjector) else FaultInjector(faults)


class FaultyBackend:
    """`DenseSearchBackend` decorator: consult the injector, then delegate.
    Capability bits, ledgers and jit-cache state (`name`, `calls`, `exact`,
    `kb_bytes`, `cold_shape*`, shard knobs) pass through to the wrapped
    backend untouched, so every caller that introspects the backend sees the
    real one."""

    def __init__(self, inner, faults: Faults):
        self.inner = inner
        self.injector = _injector(faults)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def search(self, queries, k: int):
        self.injector.fire()
        return self.inner.search(queries, k)

    def search_gathered(self, queries, cand, k: int):
        self.injector.fire()
        return self.inner.search_gathered(queries, cand, k)


class FaultyKB:
    """`SparseKB` decorator for the BM25 path: faults fire on the full-corpus
    ``score`` scan (one draw per query — BM25 scores a merged call's queries
    one by one), corpus statistics delegate untouched."""

    def __init__(self, inner, faults: Faults):
        self.inner = inner
        self.injector = _injector(faults)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def score(self, query_terms, sub=None):
        self.injector.fire()
        return self.inner.score(query_terms, sub)


def inject_faults(retriever, faults: Faults) -> FaultInjector:
    """Wrap a built retriever's KB execution path in the fault harness, in
    place: dense retrievers (EDR/ADR) get their backend wrapped, the sparse
    retriever (SR) its KB. Returns the injector (shared if one was passed)
    so callers can read the schedule log and counters."""
    inj = _injector(faults)
    if hasattr(retriever, "backend"):
        retriever.backend = FaultyBackend(retriever.backend, inj)
    else:
        retriever.kb = FaultyKB(retriever.kb, inj)
    return inj
