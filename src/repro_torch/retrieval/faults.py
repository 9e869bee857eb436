"""The exception taxonomy the serving layer's fault-tolerance shell is
written against (copied from the reference package).

KB search is a pure function of the query, so a retried call returns
byte-identical rows: `repro_torch.core.ralmspec._ServerBase._retrieve_guarded`
retries on these, and `repro_torch.serving.fleet` degrades a round when the
budget runs out. The seeded fault-injection harness that raises them on
purpose is not ported yet (see ROADMAP.md).
"""
from __future__ import annotations


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
