"""OS^3 — the Optimal Speculation Stride Scheduler (paper §4, appendix A.2).

Maximizes expected verified-documents-per-second:

  sync:   E(s) = (1 - g^s) / ((1 - g) * (s*a + b))
  async:  E(s) = (1 - g^s) / ((1 - g) * [g^s*((s-1)a + max(a,b)) + (1-g^s)*(s*a + b)])

with a = speculation-step latency (cache retrieval + LM decode stride), b =
verification latency (batched KB retrieval), g = speculation accuracy.

g is estimated by the paper's windowed MLE over the last w verification outcomes:
  g_hat = sum(M) / (sum(M) + sum(1[M < s]))           (A.2)
capped at gamma_max to avoid division blow-up as g_hat -> 1.
a, b are estimated from recent profiling (EMA over the same window).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional


def expected_verified(gamma: float, s: int) -> float:
    """(1 - g^s) / (1 - g), continuous-safe at g == 1."""
    if abs(1.0 - gamma) < 1e-9:
        return float(s)
    return (1.0 - gamma ** s) / (1.0 - gamma)


def objective(gamma: float, s: int, a: float, b: float, async_mode: bool) -> float:
    n = expected_verified(gamma, s)
    if async_mode:
        hit = gamma ** s
        lat = hit * ((s - 1) * a + max(a, b)) + (1.0 - hit) * (s * a + b)
    else:
        lat = s * a + b
    return n / max(lat, 1e-12)


@dataclass
class OS3:
    window: int = 5
    gamma_max: float = 0.6
    max_stride: int = 16
    async_mode: bool = False
    init_stride: int = 1
    a_init: float = 1e-3
    b_init: float = 1e-3

    def __post_init__(self):
        self._matches = deque(maxlen=self.window)    # M(s(t), X)
        self._strides = deque(maxlen=self.window)    # s(t)
        self._a = deque(maxlen=self.window)
        self._b = deque(maxlen=self.window)
        self.stride = self.init_stride

    # ---- profiling ------------------------------------------------------------------
    def record_speculation(self, latency: float) -> None:
        self._a.append(latency)

    def record_verification(self, latency: float, stride: int, matched: int,
                            n_participants: int = 1) -> None:
        """Record one verification outcome. ``n_participants`` amortizes a
        fleet round's shared batched KB call across the slots it served: each
        slot's effective b observation is ``latency / n_participants`` (the
        §A.1 cross-request amortization), which is the b the async objective
        must weigh against a when the fleet pipelines rounds."""
        self._b.append(latency / max(n_participants, 1))
        self._strides.append(stride)
        self._matches.append(matched)
        self.stride = self.optimal_stride()

    # ---- estimators -----------------------------------------------------------------
    @property
    def a(self) -> float:
        return sum(self._a) / len(self._a) if self._a else self.a_init

    @property
    def b(self) -> float:
        return sum(self._b) / len(self._b) if self._b else self.b_init

    @property
    def gamma(self) -> float:
        """Windowed MLE (paper A.2): matches are Bernoulli successes; a verification
        round with M < s contributes one observed failure."""
        if not self._matches:
            return 0.5
        num = sum(self._matches)
        fails = sum(1 for m, s in zip(self._matches, self._strides) if m < s)
        g = num / max(num + fails, 1)
        return min(g, self.gamma_max)

    # ---- solver ---------------------------------------------------------------------
    def optimal_stride(self, gamma: Optional[float] = None, a: Optional[float] = None,
                       b: Optional[float] = None) -> int:
        g = self.gamma if gamma is None else gamma
        a = self.a if a is None else a
        b = self.b if b is None else b
        best_s, best_v = 1, -1.0
        for s in range(1, self.max_stride + 1):
            v = objective(g, s, a, b, self.async_mode)
            if v > best_v:
                best_s, best_v = s, v
        return best_s
