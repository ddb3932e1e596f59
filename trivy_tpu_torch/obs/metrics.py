"""Minimal Prometheus metric registry, text exposition format 0.0.4 (the
port of the registry of ``trivy_tpu/obs/metrics.py``).

Counters, gauges and histograms with optional labels, rendered by
:meth:`Registry.render`. The flight recorder (compile and HBM ledgers) and
the telemetry sampler (link MB/s, device busy, arena occupancy, progress)
write to the process registry :data:`REGISTRY`. The exposition parser of
the JAX package serves its fleet poller and scan server, which the port
does not have.
"""

from __future__ import annotations

import threading

# prometheus default latency buckets (seconds)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    # HELP lines escape only backslash and newline (quotes stay literal)
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labelnames: tuple[str, ...], labelvalues: tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(f'{n}="{_escape(str(v))}"' for n, v in zip(labelnames, labelvalues))
    return "{" + pairs + "}"


def _fmt_value(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, kwargs: dict) -> tuple[str, ...]:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kwargs)} != declared "
                             f"{sorted(self.labelnames)}")
        return tuple(str(kwargs[n]) for n in self.labelnames)


class _ValueMetric(_Metric):
    """Shared per-label-set scalar storage for counters and gauges."""

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [
            f"{self.name}{_fmt_labels(self.labelnames, k)} {_fmt_value(v)}" for k, v in items
        ] or ([f"{self.name} 0"] if not self.labelnames else [])


class Counter(_ValueMetric):
    kind = "counter"


class Gauge(_ValueMetric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def remove(self, **labels) -> None:
        """Retire one label set (a finished scan's ``trace`` label)."""
        with self._lock:
            self._values.pop(self._key(labels), None)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        # per label-set: [per-bucket counts..., +Inf count], sum
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] += value

    def render(self) -> list[str]:
        lines = []
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        for key, counts in items:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                ln = _fmt_labels(self.labelnames + ("le",), key + (str(b),))
                lines.append(f"{self.name}_bucket{ln} {cum}")
            cum += counts[-1]
            ln = _fmt_labels(self.labelnames + ("le",), key + ("+Inf",))
            lines.append(f"{self.name}_bucket{ln} {cum}")
            ln = _fmt_labels(self.labelnames, key)
            lines.append(f"{self.name}_sum{ln} {_fmt_value(sums[key])}")
            lines.append(f"{self.name}_count{ln} {cum}")
        return lines


class Registry:
    """Named metric collection; get-or-create accessors are idempotent, and
    a second registration under another kind, labels or buckets raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name} already registered as {m.kind}")
            elif tuple(labelnames) != m.labelnames:
                raise ValueError(f"metric {name} already registered with labels "
                                 f"{list(m.labelnames)}, not {list(labelnames)}")
            elif "buckets" in kw and tuple(sorted(kw["buckets"])) != m.buckets:
                raise ValueError(f"histogram {name} already registered with different buckets")
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def render(self) -> str:
        out = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                out.append(f"# HELP {name} {_escape_help(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + "\n"


# the process registry the recorder and the sampler write to
REGISTRY = Registry()
