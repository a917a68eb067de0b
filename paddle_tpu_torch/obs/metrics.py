"""Process-wide metrics registry (port of paddle_tpu/obs/metrics.py; the
obs subsystem's numbers half).

One table of named metric families — counters, gauges, histograms —
exported as Prometheus-style text on ``/metrics`` (inference/serve.py).
The text is paddle_tpu's, byte for byte, for the same sequence of
operations, so a scraper or a tier aggregator written against paddle_tpu
reads the port unchanged.

Design rules:

* **Bounded label sets.** A family declares its label NAMES once; the
  number of label-value series is capped (``max_series``, default 64).
  Past the cap, new label values fold into one ``_other`` series.
* **Lock-guarded, ~zero-cost when untouched.** Each family serializes
  its mutations on one lock; a family that nothing created costs
  nothing.
* **Monotonic freshness token.** Every mutation bumps a process-global
  sequence surfaced as ``metrics_seq`` in ``/healthz``, so a scraper can
  tell a live process whose numbers move from a wedged one.

The text format is the Prometheus exposition subset ``parse_text``
understands: ``# TYPE`` comments, ``name{l="v"} value`` samples,
``_bucket``/``_sum``/``_count`` histogram triads with cumulative ``le``
buckets. Percentiles are estimated from the buckets by linear
interpolation (``percentile_from_cum``).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import locks as _locks

__all__ = [
    "Counter", "Gauge", "Histogram", "HistSnap", "Registry", "registry",
    "DEFAULT_BUCKETS_MS", "OVERFLOW_LABEL",
    "parse_text", "samples_to_hist", "percentile_from_cum",
    "render_tier",
]

# latency buckets in milliseconds: sub-ms CPU ticks up to minute-class
# compiles all land in a resolvable bucket
DEFAULT_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 5000.0, 15000.0,
                      60000.0)

# where label values past a family's series cap fold (bounded label sets)
OVERFLOW_LABEL = "_other"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Family:
    """Base: one named metric family with a fixed label-name tuple and
    a bounded set of label-value series."""

    kind = "untyped"

    def __init__(self, reg: "Registry", name: str, help_: str,
                 label_names: Tuple[str, ...], max_series: int = 64):
        self._reg = reg
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.max_series = int(max_series)
        self._series: Dict[Tuple[str, ...], object] = {}
        # ONE shared site name for every family: bounded label set
        self._lock = _locks.make_lock("metrics.family")

    def _key_of(self, labels: dict) -> Tuple[str, ...]:
        """Exact label-values key (validated). Readers use this raw —
        a never-written series must read as absent, not as the
        overflow series; the ``_other`` fold is a WRITE policy only."""
        if len(labels) != len(self.label_names) or any(
                n not in labels for n in self.label_names):
            raise ValueError(
                f"{self.name} takes exactly labels {self.label_names}; "
                f"got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.label_names)

    def _zero(self):
        raise NotImplementedError

    def _get_locked(self, labels: dict):
        # *_locked convention: the caller holds self._lock — the
        # membership test + overflow fallback + insert below are one
        # atomic step only under it
        key = self._key_of(labels)
        if key not in self._series and len(self._series) >= \
                self.max_series:
            # bounded label set: overflow series, never unbounded growth
            key = (OVERFLOW_LABEL,) * len(self.label_names)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._zero()
        return s

    def remove(self, **labels) -> None:
        """Drop one series (exact match). For label values whose
        subject is GONE — a retired replica's breaker gauge must not
        read 1 forever, nor hold a slot against the series cap."""
        with self._lock:
            self._series.pop(self._key_of(labels), None)
        self._reg._bump()

    def series(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._series)


class Counter(_Family):
    kind = "counter"

    def _zero(self):
        return [0.0]

    def inc(self, n: float = 1, **labels) -> None:
        with self._lock:
            self._get_locked(labels)[0] += n
        self._reg._bump()

    def value(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key_of(labels))
            return float(s[0]) if s else 0.0

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        out.append(f"# TYPE {self.name} counter")
        for key, s in items:
            out.append(f"{self.name}"
                       f"{_fmt_labels(self.label_names, key)} {s[0]:g}")


class Gauge(_Family):
    kind = "gauge"

    def _zero(self):
        return [0.0]

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._get_locked(labels)[0] = float(v)
        self._reg._bump()

    def inc(self, n: float = 1, **labels) -> None:
        with self._lock:
            self._get_locked(labels)[0] += n
        self._reg._bump()

    def value(self, **labels) -> float:
        with self._lock:
            s = self._series.get(self._key_of(labels))
            return float(s[0]) if s else 0.0

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        out.append(f"# TYPE {self.name} gauge")
        for key, s in items:
            out.append(f"{self.name}"
                       f"{_fmt_labels(self.label_names, key)} {s[0]:g}")


class HistSnap:
    """Point-in-time copy of one histogram series — subtractable so a
    bench can report percentiles over exactly its measured phase."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges, counts, sum_, count):
        self.edges = tuple(edges)
        self.counts = list(counts)          # per-bucket, NOT cumulative
        self.sum = float(sum_)
        self.count = int(count)

    def minus(self, earlier: "HistSnap") -> "HistSnap":
        return HistSnap(self.edges,
                        [a - b for a, b in zip(self.counts,
                                               earlier.counts)],
                        self.sum - earlier.sum,
                        self.count - earlier.count)

    def percentile(self, q: float) -> float:
        cum, acc = [], 0.0
        for c in self.counts:
            acc += c
            cum.append(acc)
        return percentile_from_cum(self.edges, cum, q)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, reg, name, help_, label_names,
                 buckets: Optional[Sequence[float]] = None,
                 max_series: int = 64):
        super().__init__(reg, name, help_, label_names, max_series)
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_BUCKETS_MS))

    def _zero(self):
        # [per-bucket counts..., +Inf count, sum, count]
        return [[0] * (len(self.buckets) + 1), 0.0, 0]

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        with self._lock:
            s = self._get_locked(labels)
            i = len(self.buckets)
            for j, edge in enumerate(self.buckets):
                if v <= edge:
                    i = j
                    break
            s[0][i] += 1
            s[1] += v
            s[2] += 1
        self._reg._bump()

    def snap(self, **labels) -> HistSnap:
        key_labels = labels or {}
        with self._lock:
            s = self._series.get(self._key_of(key_labels))
            if s is None:
                return HistSnap(self.buckets,
                                [0] * (len(self.buckets) + 1), 0.0, 0)
            return HistSnap(self.buckets, list(s[0]), s[1], s[2])

    def render(self, out: List[str]) -> None:
        with self._lock:
            items = sorted((k, (list(s[0]), s[1], s[2]))
                           for k, s in self._series.items())
        out.append(f"# TYPE {self.name} histogram")
        for key, (counts, sum_, count) in items:
            acc = 0
            for edge, c in zip(self.buckets, counts):
                acc += c
                le = (("le", f"{edge:g}"),)
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(self.label_names, key, le)} {acc}")
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.label_names, key, (('le', '+Inf'),))}"
                f" {count}")
            lbl = _fmt_labels(self.label_names, key)
            out.append(f"{self.name}_sum{lbl} {sum_:g}")
            out.append(f"{self.name}_count{lbl} {count}")


class Registry:
    """Get-or-create table of metric families; ONE per process
    (module-level ``registry``). A second create with the same name
    returns the existing family (kind mismatches raise — two
    subsystems silently sharing a name under different types is a
    corruption, not a convenience)."""

    def __init__(self):
        self._lock = _locks.make_rlock("metrics.registry")
        self._families: Dict[str, _Family] = {}
        self._seq = 0

    def _bump(self):
        # freshness token only: a plain GIL-guarded int
        self._seq += 1

    def seq(self) -> int:
        return self._seq

    def _get_or_create(self, cls, name, help_, labels, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(self, name, help_, tuple(labels), **kw)
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{fam.kind}, requested {cls.kind}")
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = (), max_series: int = 64
                ) -> Counter:
        return self._get_or_create(Counter, name, help_, labels,
                                   max_series=max_series)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = (), max_series: int = 64) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labels,
                                   max_series=max_series)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None,
                  max_series: int = 64) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labels,
                                   buckets=buckets,
                                   max_series=max_series)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def render(self) -> str:
        with self._lock:
            fams = sorted(self._families.values(),
                          key=lambda f: f.name)
        out: List[str] = []
        for fam in fams:
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            fam.render(out)
        return "\n".join(out) + ("\n" if out else "")


#: the ONE process-wide registry every instrumented site writes to
registry = Registry()


# ---------------------------------------------------------------------------
# text parsing + aggregation (a router tier's scrape, percentiles)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_text(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse exposition text into ``(name, labels, value)`` samples.
    Tolerant of comment/blank lines; malformed lines are skipped (a
    scrape of a half-dead replica must degrade, not raise)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_v = m.groups()
        try:
            v = float(raw_v)
        except ValueError:
            continue
        labels = {k: val.replace(r'\"', '"').replace(r"\\", "\\")
                  for k, val in _LABEL_RE.findall(raw_labels or "")}
        out.append((name, labels, v))
    return out


def percentile_from_cum(edges: Sequence[float], cum: Sequence[float],
                        q: float) -> float:
    """Estimate the q-quantile (q in [0,1]) from cumulative bucket
    counts ``cum`` over upper ``edges`` (+Inf implied as the last cum
    entry when ``len(cum) == len(edges) + 1``). Linear interpolation
    inside the winning bucket; the +Inf bucket clamps to the last
    finite edge (the estimate cannot exceed what the buckets resolve)."""
    if not cum or not edges:
        return 0.0
    total = cum[-1]
    if total <= 0:
        return 0.0
    target = q * total
    prev = 0.0
    for i, c in enumerate(cum):
        if c >= target and c > prev:
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i] if i < len(edges) else edges[-1]
            if hi <= lo or not math.isfinite(hi):
                return float(lo)
            frac = (target - prev) / (c - prev)
            return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
        prev = max(prev, c)
    return float(edges[-1])


def samples_to_hist(samples: Iterable[Tuple[str, Dict[str, str], float]],
                    name: str, **match_labels
                    ) -> Tuple[List[float], List[float]]:
    """Collect one histogram's ``_bucket`` samples (summed across any
    non-``le`` label splits that match ``match_labels``) into
    ``(edges, cumulative_counts)`` ready for ``percentile_from_cum``."""
    by_le: Dict[float, float] = {}
    inf = 0.0
    for n, labels, v in samples:
        if n != f"{name}_bucket":
            continue
        if any(labels.get(k) != str(val)
               for k, val in match_labels.items()):
            continue
        le = labels.get("le", "")
        if le in ("+Inf", "inf", "Inf"):
            inf += v
        else:
            try:
                by_le[float(le)] = by_le.get(float(le), 0.0) + v
            except ValueError:
                continue
    edges = sorted(by_le)
    cum = [by_le[e] for e in edges] + [max(inf, by_le[edges[-1]]
                                           if edges else inf)]
    return edges, cum


def render_tier(own_text: str, replica_texts: Dict[str, str],
                prefix: str = "ptpu_", tier_prefix: str = "ptpu_tier_"
                ) -> str:
    """The router's /metrics body: its own series verbatim, every
    scraped replica's samples re-labeled ``replica="rN"``, and
    tier-level aggregates — each ``ptpu_*`` sample summed across
    replicas under ``ptpu_tier_*`` (counters and cumulative histogram
    buckets sum exactly; summed gauges read as tier totals, e.g.
    aggregate slot occupancy)."""
    out = [own_text.rstrip("\n")] if own_text.strip() else []
    agg: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for rname, text in sorted(replica_texts.items()):
        for name, labels, v in parse_text(text):
            items = tuple(sorted(labels.items()))
            lbl_txt = "{" + ",".join(
                [f'{k}="{_escape(val)}"' for k, val in items]
                + [f'replica="{_escape(rname)}"']) + "}"
            out.append(f"{name}{lbl_txt} {v:g}")
            if name.startswith(prefix):
                key = (tier_prefix + name[len(prefix):], items)
                agg[key] = agg.get(key, 0.0) + v
    for (name, items), v in sorted(agg.items()):
        lbl_txt = ("{" + ",".join(f'{k}="{_escape(val)}"'
                                  for k, val in items) + "}"
                   if items else "")
        out.append(f"{name}{lbl_txt} {v:g}")
    return "\n".join(out) + ("\n" if out else "")
