"""Metrics plane shared by the functional DB and the timing sim.

Three metric kinds, mirroring the Prometheus data model:

- ``Counter``   -- monotone event counts (txns admitted, aborts, WAL appends).
- ``Gauge``     -- instantaneous levels (in-flight batches, backlog depth).
- ``Histogram`` -- latency distributions over *fixed log-spaced buckets* so
  p50/p99/p999 are deterministic functions of the observed multiset, not of
  sampling order or reservoir luck.  Bucket edges are geometric with
  ``per_decade`` edges per decade; quantile estimates interpolate
  geometrically inside a bucket, so the relative error of any quantile is
  bounded by one bucket ratio (``10 ** (1 / per_decade)``, ~15.5% at the
  default 16/decade).

A ``MetricsRegistry`` owns families of metrics keyed by (name, labels) and is
what the exporter (``repro.obs.export``) walks.  Everything here is pure
Python + numpy: no background threads, no clocks, no RNG -- the registry can
never perturb engine results, which is what pin row 10 asserts.
"""

from __future__ import annotations

import collections
import math

import numpy as np

# Default latency bucket span: 100 ns .. 10 s, 16 edges per decade.
DEFAULT_LO = 1e-7
DEFAULT_HI = 10.0
PER_DECADE = 16


def log_bucket_bounds(lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                      per_decade: int = PER_DECADE) -> np.ndarray:
    """Geometric bucket upper edges lo .. hi inclusive (plus implicit +Inf)."""
    n_decades = math.log10(hi / lo)
    n = int(round(n_decades * per_decade))
    # Exact exponent grid keeps edges reproducible across platforms.
    exps = np.arange(n + 1, dtype=np.float64) / per_decade
    return lo * np.power(10.0, exps)


class Counter:
    """Monotone counter.  ``_set`` exists only for the Cluster.stats mirror."""

    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name, help="", labels=()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def inc(self, n=1.0):
        self.value += n

    def _set(self, v):
        self.value = float(v)


class Gauge:
    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name, help="", labels=()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def inc(self, n=1.0):
        self.value += n

    def dec(self, n=1.0):
        self.value -= n


class Histogram:
    """Fixed log-spaced-bucket histogram with deterministic quantiles.

    ``counts[i]`` counts observations ``v <= bounds[i]`` (first matching
    bucket, Prometheus ``le`` semantics); ``counts[-1]`` is the +Inf bucket.
    """

    __slots__ = ("name", "help", "labels", "bounds", "counts", "sum", "_ratio")

    def __init__(self, name, help="", labels=(), lo=DEFAULT_LO, hi=DEFAULT_HI,
                 per_decade=PER_DECADE):
        self.name = name
        self.help = help
        self.labels = labels
        self.bounds = log_bucket_bounds(lo, hi, per_decade)
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.sum = 0.0
        self._ratio = 10.0 ** (1.0 / per_decade)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def observe(self, v: float):
        idx = int(np.searchsorted(self.bounds, v, side="left"))
        self.counts[idx] += 1
        self.sum += v

    def observe_many(self, values):
        vals = np.asarray(values, dtype=np.float64)
        if vals.size == 0:
            return
        idx = np.searchsorted(self.bounds, vals, side="left")
        self.counts += np.bincount(idx, minlength=len(self.counts))
        self.sum += float(vals.sum())

    def percentile(self, q: float) -> float:
        """Quantile estimate, q in [0, 1].  Deterministic: rank-walk over the
        cumulative bucket counts, geometric interpolation within the bucket."""
        n = self.count
        if n == 0:
            return 0.0
        rank = min(n, max(1, math.ceil(q * n)))
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.bounds):          # +Inf bucket: clamp to top edge
                    return float(self.bounds[-1])
                hi_edge = float(self.bounds[i])
                lo_edge = float(self.bounds[i - 1]) if i > 0 else hi_edge / self._ratio
                frac = (rank - cum) / c
                return lo_edge * (hi_edge / lo_edge) ** frac
            cum += c
        return float(self.bounds[-1])

    def quantiles(self, qs=(0.5, 0.99, 0.999)) -> dict:
        return {f"p{str(q).replace('0.', '')}": self.percentile(q) for q in qs}

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum / n if n else 0.0


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name, kind, help):
        self.name = name
        self.kind = kind
        self.help = help
        self.children = {}          # labels tuple -> metric


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Ordered collection of metric families; the exporter walks it."""

    def __init__(self, namespace="p4db"):
        self.namespace = namespace
        self._families: "collections.OrderedDict[str, _Family]" = collections.OrderedDict()

    def _child(self, kind, name, help, labels, **hist_kw):
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"metric {name!r} already registered as {fam.kind}")
        key = tuple(sorted(labels.items()))
        child = fam.children.get(key)
        if child is None:
            cls = _KINDS[kind]
            child = cls(name, help=fam.help, labels=key, **hist_kw) if kind == "histogram" \
                else cls(name, help=fam.help, labels=key)
            fam.children[key] = child
        return child

    def counter(self, name, help="", **labels) -> Counter:
        return self._child("counter", name, help, labels)

    def gauge(self, name, help="", **labels) -> Gauge:
        return self._child("gauge", name, help, labels)

    def histogram(self, name, help="", lo=DEFAULT_LO, hi=DEFAULT_HI,
                  per_decade=PER_DECADE, **labels) -> Histogram:
        return self._child("histogram", name, help, labels,
                           lo=lo, hi=hi, per_decade=per_decade)

    def get(self, name, **labels):
        fam = self._families.get(name)
        if fam is None:
            return None
        return fam.children.get(tuple(sorted(labels.items())))

    def families(self):
        return self._families.values()

    def snapshot(self) -> dict:
        """JSON-able dump of every family: {name: {type, help, samples: [...]}}."""
        out = {}
        for fam in self._families.values():
            samples = []
            for key, m in fam.children.items():
                labels = dict(key)
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "buckets": {f"{b:.6g}": int(c)
                                    for b, c in zip(m.bounds, m.counts[:-1]) if c},
                        "inf": int(m.counts[-1]),
                        "sum": m.sum,
                        "count": m.count,
                        "p50": m.percentile(0.50),
                        "p99": m.percentile(0.99),
                        "p999": m.percentile(0.999),
                    })
                else:
                    samples.append({"labels": labels, "value": m.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help, "samples": samples}
        return out


class StatsCounter(collections.Counter):
    """Drop-in ``collections.Counter`` whose writes mirror into a registry.

    ``Cluster.stats`` is compared with ``==`` across clusters and read as
    ``dict(c.stats)`` all over the test suite; subclassing Counter keeps
    zero-count equality and arithmetic semantics byte-for-byte while every
    ``stats[k] += n`` also lands in a registry counter (absolute value, since
    Counter keys can in principle be rewritten).
    """

    def __init__(self, registry=None, name_fn=None):
        super().__init__()
        self._registry = registry
        self._name_fn = name_fn

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if self._registry is not None:
            name, help = self._name_fn(key) if self._name_fn else (str(key), "")
            self._registry.counter(name, help=help)._set(value)

    def __reduce__(self):  # plain Counter on copy/pickle: the mirror is a view
        return (collections.Counter, (dict(self),))


class OccupancyMeter:
    """Time-weighted occupancy integral for pool utilization (credit slots,
    admit slots).  ``adjust(+1, now)`` on acquire, ``adjust(-1, now)`` on
    release; ``integral(now)`` returns held slot-seconds."""

    __slots__ = ("level", "_t", "_area", "peak")

    def __init__(self, t0=0.0):
        self.level = 0
        self._t = t0
        self._area = 0.0
        self.peak = 0

    def adjust(self, delta, now):
        if now > self._t:
            self._area += self.level * (now - self._t)
            self._t = now
        self.level += delta
        if self.level > self.peak:
            self.peak = self.level

    def integral(self, now):
        return self._area + self.level * max(0.0, now - self._t)
