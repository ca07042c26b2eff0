"""Metrics primitives: counters, gauges, and streaming-quantile histograms.

Everything here is host-side pure python — safe to update from inside the
training loop's dispatch path (no jax imports, no allocation beyond a few
floats per metric).  Histograms estimate P50/P95/P99 with the P² algorithm
(Jain & Chlamtac, CACM 1985): five markers per quantile, O(1) per
observation, no sample buffer to grow over a long run.

A copy of ``repro.obs.metrics``; the port keeps its own, as it imports
nothing of the JAX package.
"""

from __future__ import annotations

import math


class P2Quantile:
    """Streaming estimate of one quantile via the P² algorithm.

    Keeps 5 marker heights whose positions track the desired quantile's
    ideal rank; markers move by parabolic (fallback linear) interpolation.
    Exact for the first 5 observations, O(1) memory and time after.
    """

    __slots__ = ("q", "count", "_h", "_n", "_d", "_dn")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.count = 0
        self._h: list[float] = []                      # marker heights
        self._n = [0.0, 1.0, 2.0, 3.0, 4.0]            # marker positions
        self._d = [0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0]  # desired positions
        self._dn = [0.0, q / 2, q, (1 + q) / 2, 1.0]   # desired increments

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        h = self._h
        if len(h) < 5:
            h.append(x)
            h.sort()
            return
        n, d = self._n, self._d
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            d[i] += self._dn[i]
        for i in (1, 2, 3):
            diff = d[i] - n[i]
            if (diff >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                diff <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                s = 1.0 if diff > 0 else -1.0
                hp = h[i] + s / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
                )
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # parabolic prediction left the bracket: move linearly
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += s

    @property
    def value(self) -> float:
        if not self._h:
            return float("nan")
        if self.count < 5:  # still exact: nearest rank over what we have
            xs = sorted(self._h)
            return xs[min(len(xs) - 1, round(self.q * (len(xs) - 1)))]
        return self._h[2]


class Counter:
    """Monotonically-increasing total (events, tokens, preemptions)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        self.value += float(n)


class Gauge:
    """Last-written value (queue depth, occupancy, current lr)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


_QUANTILES = (0.5, 0.95, 0.99)
_QLABEL = {0.5: "p50", 0.95: "p95", 0.99: "p99"}


class Histogram:
    """Streaming distribution: count/sum/min/max + P² P50/P95/P99."""

    __slots__ = ("count", "sum", "min", "max", "_q")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._q = {q: P2Quantile(q) for q in _QUANTILES}

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for est in self._q.values():
            est.observe(v)

    def quantile(self, q: float) -> float:
        return self._q[q].value

    def stats(self) -> dict[str, float]:
        if not self.count:
            return {"count": 0}
        out = {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
        }
        for q, est in self._q.items():
            out[_QLABEL[q]] = est.value
        return out


class MetricsRegistry:
    """Named metrics, get-or-create: ``reg.histogram("train.step_time_s")``.

    A name is bound to one metric type for the registry's lifetime —
    re-requesting it as a different type raises, so a typo'd publisher
    fails loudly instead of splitting a series.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"requested as {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def kind_of(self, name: str) -> str:
        return type(self._metrics[name]).__name__.lower()

    def snapshot(self) -> dict[str, float | dict[str, float]]:
        """Point-in-time view: scalars for counters/gauges, stats dicts for
        histograms; sorted by name so exports are stable."""
        out: dict[str, float | dict[str, float]] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.stats() if isinstance(m, Histogram) else m.value
        return out
