"""Metrics plane: counters, gauges, fixed-bucket streaming histograms,
and Prometheus text exposition.

A copy of ``lstm_tensorspark_tpu/obs/metrics.py`` (which imports neither
JAX nor anything of its package): the port keeps its own so it never
imports the JAX package, and its ``GET /metrics`` text is the JAX
server's, byte for byte, for the same operations.

- **thread-safe**: every instrument guards its state with one small lock;
  an ``observe``/``inc`` is a lock and an add (and one bisect for a
  histogram): no allocation, no formatting, no I/O;
- **fixed buckets**: histograms keep per-bucket counts and ``sum`` /
  ``count``, never samples; quantiles (p50/p99) are interpolated inside
  the target bucket, as Prometheus' ``histogram_quantile`` does;
- **no-op when disabled**: components take a registry parameter, and
  :data:`NULL_REGISTRY` hands back no-op instruments (``serve
  --telemetry off``);
- **idempotent registration**: asking a registry for an existing name
  returns that family; re-registering it with another kind, label set or
  bucket set is an error.

:meth:`MetricsRegistry.render_prometheus` emits the text format (``#
HELP`` / ``# TYPE``, histograms as cumulative ``_bucket{le=}`` series and
``_sum`` / ``_count``); :func:`parse_exposition` is the matching
validator.
"""

from __future__ import annotations

import bisect
import math
import re
import threading

#: default buckets for latency histograms (seconds): sub-ms resolution at
#: the low end (CPU inter-token gaps on small models), up to the serving
#: timeout at the top. The +Inf overflow bucket is implicit.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABELNAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (set wins; inc/dec for running levels)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket streaming histogram (per-bucket counts + sum + count;
    never stores samples). ``buckets`` are the upper bounds (``le``,
    inclusive), strictly increasing; the +Inf overflow bucket is
    implicit."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(not math.isfinite(x) for x in b):
            raise ValueError(f"need >= 1 finite bucket bound, got {buckets!r}")
        if any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"bucket bounds must strictly increase: {b!r}")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        # le is inclusive: a value exactly on a bound lands in that bucket
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """Consistent (bucket_counts, sum, count) under one lock hold."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def _quantile_from(self, counts: list[int], total: int,
                       q: float) -> float:
        return _estimate_quantile(self.buckets, counts, total, q)

    def quantile(self, q: float) -> float:
        counts, _, total = self.snapshot()
        return self._quantile_from(counts, total, q)

    @property
    def value(self) -> float:  # uniform read surface with Counter/Gauge
        with self._lock:
            return float(self._count)

    def summary(self) -> dict:
        # ONE snapshot: count/sum/p50/p99 must describe the same sample
        # set even while another thread is observing
        counts, s, total = self.snapshot()
        out = {"count": total, "sum": round(s, 6)}
        if total:
            out["p50"] = round(self._quantile_from(counts, total, 0.5), 6)
            out["p99"] = round(self._quantile_from(counts, total, 0.99), 6)
        return out


def _estimate_quantile(buckets: tuple[float, ...], counts: list[int],
                       total: int, q: float) -> float:
    """Estimated q-quantile over one consistent ``counts`` snapshot:
    linear interpolation inside the bucket holding the target rank —
    Prometheus' ``histogram_quantile`` estimate, computed locally.
    NaN when empty; clamped to the largest finite bound for
    overflow-bucket ranks. Module-level so a MERGED multi-child count
    vector (``_Family.aggregate``) summarises exactly like a single
    child's."""
    if total == 0:
        return float("nan")
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            if i >= len(buckets):  # overflow bucket: no upper bound
                return buckets[-1]
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            return lo + (hi - lo) * ((rank - cum) / c)
        cum += c
    return buckets[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric family: labelled children (or a single anonymous
    child for label-less metrics, to which the convenience methods
    ``inc``/``set``/``dec``/``observe`` delegate)."""

    def __init__(self, kind: str, name: str, help_: str,
                 labelnames: tuple[str, ...], buckets=None):
        for ln in labelnames:
            if not _LABELNAME_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} for {name}")
        self.kind = kind
        self.name = _check_name(name)
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            # eager anonymous child: a label-less metric exports 0 from
            # registration on (absent-vs-zero matters to alert rules)
            self._children[()] = self._make()

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self._buckets or DEFAULT_LATENCY_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        # resolution path, not the record path (record sites hold the
        # resolved child): always lock — the unlocked-get fast path read
        # _children while another thread's setdefault mutated it
        with self._lock:
            return self._children.setdefault(key, self._make())

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def _merge_instances(self, insts: list):
        """Aggregate a group of children: counters/gauges sum; histograms
        merge per-bucket counts EXACTLY (every child shares the family's
        bucket bounds) and summarise the merged distribution — so the
        merged view quantizes identically to a single child's summary."""
        if self.kind != "histogram":
            return sum(inst.value for inst in insts)
        merged: list[int] | None = None
        msum, mtotal = 0.0, 0
        for inst in insts:
            counts, s, total = inst.snapshot()
            merged = (counts if merged is None
                      else [a + b for a, b in zip(merged, counts)])
            msum += s
            mtotal += total
        out = {"count": mtotal, "sum": round(msum, 6)}
        if mtotal and merged is not None:
            bounds = tuple(float(b) for b in
                           (self._buckets or DEFAULT_LATENCY_BUCKETS))
            out["p50"] = round(
                _estimate_quantile(bounds, merged, mtotal, 0.5), 6)
            out["p99"] = round(
                _estimate_quantile(bounds, merged, mtotal, 0.99), 6)
        return out

    def aggregate_over(self, label: str) -> dict:
        """Aggregates with ``label`` summed out, keyed by the residual
        label string (``""`` when ``label`` is the only one). Summing a
        SPECIFIC label keeps the residual series meaningful — e.g.
        ``serve_requests_total{outcome=,replica=}`` aggregated over
        ``replica`` yields per-``outcome`` fleet totals, exactly the key
        shapes consumers used before the ``replica`` label existed —
        whereas a blind all-children sum would fold unrelated label
        values (states, outcomes) into one meaningless number."""
        if label not in self.labelnames:
            return {}
        idx = self.labelnames.index(label)
        residual = tuple(n for n in self.labelnames if n != label)
        groups: dict[tuple[str, ...], list] = {}
        for key, inst in self.children():
            rkey = tuple(v for i, v in enumerate(key) if i != idx)
            groups.setdefault(rkey, []).append(inst)
        return {_labelstr(residual, rkey): self._merge_instances(insts)
                for rkey, insts in groups.items()}

    def snapshot_delta(self, cursor: dict | None = None):
        """Windowed (delta-since-``cursor``) view of this family, merged
        across every labelled child. Returns ``(view, new_cursor)`` —
        pass the returned cursor back to the next call to advance the
        window; ``None`` means "since registration".

        The registry's instruments are CUMULATIVE over the process life,
        so any consumer reacting to ``summary()`` reacts to boot-time
        history: a controller watching lifetime p99s would still see
        yesterday's burst. The delta view subtracts the cursor's bucket
        counts per child before merging, so the estimated quantiles
        describe ONLY the samples recorded inside the window — the
        recent-biased signal the serve autotuner steers on.

        View shapes: histograms → ``{count, sum[, p50, p99]}`` over the
        delta distribution; counters → the float increment over the
        window; gauges → the current summed level (a gauge is a level,
        not a flow — there is no meaningful delta). Each consumer holds
        its own cursor, so independent readers never reset each other
        (unlike a read-and-clear API)."""
        children = self.children()
        prev = cursor or {}
        new_cursor: dict = {}
        if self.kind == "histogram":
            bounds = tuple(float(b) for b in
                           (self._buckets or DEFAULT_LATENCY_BUCKETS))
            merged = [0] * (len(bounds) + 1)
            msum, mtotal = 0.0, 0
            for key, inst in children:
                counts, s, total = inst.snapshot()
                new_cursor[key] = (list(counts), s, total)
                pc = prev.get(key)
                if pc is not None:
                    counts = [a - b for a, b in zip(counts, pc[0])]
                    s -= pc[1]
                    total -= pc[2]
                merged = [a + b for a, b in zip(merged, counts)]
                msum += s
                mtotal += total
            out: dict = {"count": mtotal, "sum": round(msum, 6)}
            if mtotal:
                out["p50"] = round(
                    _estimate_quantile(bounds, merged, mtotal, 0.5), 6)
                out["p99"] = round(
                    _estimate_quantile(bounds, merged, mtotal, 0.99), 6)
            return out, new_cursor
        total = 0.0
        for key, inst in children:
            v = inst.value
            new_cursor[key] = v
            if self.kind == "counter":
                total += v - prev.get(key, 0.0)
            else:  # gauge: a level, reported as-is
                total += v
        return total, new_cursor

    # -- label-less convenience (delegates to the anonymous child) -------

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def snapshot(self):
        return self.labels().snapshot()

    def quantile(self, q: float) -> float:
        return self.labels().quantile(q)

    @property
    def value(self) -> float:
        return self.labels().value

    def summary(self) -> dict:
        return self.labels().summary()


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labelstr(names: tuple[str, ...], values: tuple[str, ...],
              extra: tuple[tuple[str, str], ...] = ()) -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    parts += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """A namespace of metric families. One process-wide default lives at
    ``obs.REGISTRY``; components accept a registry parameter so tests and
    benchmarks can scope measurements to one server."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, kind: str, name: str, help_: str,
                labelnames: tuple[str, ...], buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, cannot re-register "
                        f"as {kind}{tuple(labelnames)}")
                if (kind == "histogram"
                        and tuple(float(b) for b in buckets)
                        != tuple(float(b) for b in fam._buckets)):
                    # silently folding a caller's observations into buckets
                    # it didn't ask for would quantize its quantiles to the
                    # wrong resolution — same one-name-one-meaning rule
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam._buckets}, cannot re-register with "
                        f"{tuple(buckets)}")
                return fam
            fam = _Family(kind, name, help_, tuple(labelnames), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> _Family:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> _Family:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                  labelnames: tuple[str, ...] = ()) -> _Family:
        return self._family("histogram", name, help, labelnames, buckets)

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- output surfaces -------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): histograms as
        cumulative ``_bucket{le=}`` series + ``_sum``/``_count``."""
        lines: list[str] = []
        for fam in self.families():
            children = fam.children()
            if not children:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, inst in children:
                if fam.kind != "histogram":
                    lines.append(
                        f"{fam.name}{_labelstr(fam.labelnames, key)} "
                        f"{_fmt_value(inst.value)}")
                    continue
                counts, s, total = inst.snapshot()
                cum = 0
                for bound, c in zip(inst.buckets, counts):
                    cum += c
                    ls = _labelstr(fam.labelnames, key,
                                   (("le", _fmt_value(bound)),))
                    lines.append(f"{fam.name}_bucket{ls} {cum}")
                ls = _labelstr(fam.labelnames, key, (("le", "+Inf"),))
                lines.append(f"{fam.name}_bucket{ls} {total}")
                ls = _labelstr(fam.labelnames, key)
                lines.append(f"{fam.name}_sum{ls} {_fmt_value(s)}")
                lines.append(f"{fam.name}_count{ls} {total}")
        return "\n".join(lines) + "\n"

    def summaries(self) -> dict:
        """JSON-ready view for ``/stats``: counters/gauges as values,
        histograms as {count, sum, p50, p99}. ``replica``-labelled
        families ALSO export aggregates with the replica label summed
        out, under the residual-label keys (the bare family name for
        replica-only families) — so consumers keyed on
        ``serve_ttft_seconds`` or ``serve_requests_total{outcome="..."}``
        keep working when a family grows the ``replica`` label, and the
        per-child ``name{...,replica="r"}`` entries carry the split."""
        out: dict = {}
        for fam in self.families():
            children = fam.children()
            for key, inst in children:
                name = fam.name + _labelstr(fam.labelnames, key)
                out[name] = (inst.summary() if fam.kind == "histogram"
                             else inst.value)
            if "replica" in fam.labelnames and children:
                for suffix, val in fam.aggregate_over("replica").items():
                    out[fam.name + suffix] = val
        return out

    def snapshot(self) -> dict:
        """Flat {metric: number} for one JSONL record (histograms expand
        to _count/_sum/_p50/_p99 keys)."""
        out: dict = {}
        for fam in self.families():
            for key, inst in fam.children():
                name = fam.name + _labelstr(fam.labelnames, key)
                if fam.kind != "histogram":
                    out[name] = inst.value
                    continue
                s = inst.summary()
                out[name + "_count"] = s["count"]
                out[name + "_sum"] = s["sum"]
                if "p50" in s:
                    out[name + "_p50"] = s["p50"]
                    out[name + "_p99"] = s["p99"]
        return out


class _NullInstrument:
    """No-op counter/gauge/histogram: the disabled-telemetry fast path."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def labels(self, **kv):
        return self

    def aggregate_over(self, label: str) -> dict:
        # mirrors _Family.aggregate_over for disabled telemetry: the
        # router reads the queue-wait p99 through this to size Retry-After
        return {}

    def snapshot_delta(self, cursor: dict | None = None):
        # mirrors _Family.snapshot_delta: a histogram-shaped empty window
        # — a controller on a --telemetry off stack sees zero traffic and
        # never moves a knob (the CLI refuses the combination anyway)
        return {"count": 0, "sum": 0.0}, {}

    @property
    def value(self) -> float:
        return 0.0

    def summary(self) -> dict:
        return {}


_NULL = _NullInstrument()


class NullRegistry:
    """Registry that hands out no-op instruments (``--telemetry off``)."""

    def counter(self, *a, **k):
        return _NULL

    def gauge(self, *a, **k):
        return _NULL

    def histogram(self, *a, **k):
        return _NULL

    def families(self):
        return []

    def render_prometheus(self) -> str:
        return "# telemetry disabled\n"

    def summaries(self) -> dict:
        return {}

    def snapshot(self) -> dict:
        return {}


#: the port's process-wide default registry (a serve stack built without
#: one records here; it is never the JAX package's)
REGISTRY = MetricsRegistry()
#: shared no-op registry for disabled telemetry
NULL_REGISTRY = NullRegistry()


# ---- exposition validation (the format contract, executable) -----------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                          # optional label block
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)|NaN|[+-]Inf)$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_number(s: str) -> float:
    if s == "NaN":
        return float("nan")
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


def parse_exposition(text: str) -> dict:
    """Parse + validate Prometheus text exposition. Returns
    ``{family_name: {"type": kind, "samples": [(name, labels, value)]}}``
    and raises ``ValueError`` on any format violation: unparseable lines,
    samples without a ``# TYPE``, non-monotonic histogram buckets, a
    missing/mismatched ``+Inf`` bucket, or ``_count`` disagreeing with it.
    """
    types: dict[str, str] = {}
    fams: dict[str, dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) != 4 or parts[3] not in _KINDS:
                raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
            types[parts[2]] = parts[3]
            fams.setdefault(parts[2], {"type": parts[3], "samples": []})
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name, labelblock, value = m.group(1), m.group(2), m.group(3)
        labels: dict[str, str] = {}
        if labelblock:
            consumed = sum(
                len(p.group(0)) for p in _LABEL_PAIR_RE.finditer(labelblock))
            n_pairs = len(_LABEL_PAIR_RE.findall(labelblock))
            # every char must belong to a pair or a separating comma
            if consumed + max(n_pairs - 1, 0) != len(labelblock):
                raise ValueError(
                    f"line {lineno}: bad label block {{{labelblock}}}")
            labels = dict(_LABEL_PAIR_RE.findall(labelblock))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stripped = name[: -len(suffix)] if name.endswith(suffix) else None
            if stripped and types.get(stripped) == "histogram":
                base = stripped
                break
        if base not in types:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no # TYPE declaration")
        fams[base]["samples"].append((name, labels, _parse_number(value)))

    for fname, fam in fams.items():
        if fam["type"] != "histogram":
            continue
        # group bucket series by their non-le labelset
        series: dict[tuple, dict] = {}
        for name, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.setdefault(key, {"buckets": [], "sum": None,
                                        "count": None})
            if name == fname + "_bucket":
                if "le" not in labels:
                    raise ValueError(f"{fname}: bucket sample without le=")
                s["buckets"].append((_parse_number(labels["le"]), value))
            elif name == fname + "_sum":
                s["sum"] = value
            elif name == fname + "_count":
                s["count"] = value
        for key, s in series.items():
            if not s["buckets"]:
                raise ValueError(f"{fname}{dict(key)}: no bucket samples")
            bounds = [b for b, _ in s["buckets"]]
            counts = [c for _, c in s["buckets"]]
            if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
                raise ValueError(f"{fname}{dict(key)}: le bounds not "
                                 "strictly increasing")
            if counts != sorted(counts):
                raise ValueError(f"{fname}{dict(key)}: cumulative bucket "
                                 f"counts decrease: {counts}")
            if bounds[-1] != float("inf"):
                raise ValueError(f"{fname}{dict(key)}: missing +Inf bucket")
            if s["count"] is None or s["sum"] is None:
                raise ValueError(f"{fname}{dict(key)}: missing _sum/_count")
            if s["count"] != counts[-1]:
                raise ValueError(
                    f"{fname}{dict(key)}: _count {s['count']} != +Inf "
                    f"bucket {counts[-1]}")
    return fams
