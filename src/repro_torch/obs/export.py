"""Metric export: JSONL snapshots and Prometheus text exposition (PyTorch
port of ``repro/obs/export.py``).

One :class:`~repro_torch.obs.metrics.MetricsRegistry` in, two wire formats
out:

* :func:`write_jsonl` — one JSON object per sample line, the benchmark/CI
  artifact format (diffable, greppable, loads with one ``json.loads`` per
  line).  Histograms emit one line carrying buckets + sum + count.
* :func:`to_prometheus` / :func:`write_prometheus` — the text exposition
  format a Prometheus scrape endpoint serves (``# HELP``/``# TYPE``
  headers, ``_bucket{le=...}``/``_sum``/``_count`` histogram series).

:func:`export_run_stats` publishes a finished run's
:class:`~repro_torch.core.scheduler.RunStats` into the registry under
``trees_run_<key>`` gauges using ``RunStats.as_dict()`` — the *same* metric
vocabulary as the JAX package's export, so dashboards read both packages'
series under one set of names.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

from ..core.scheduler import RunStats
from .metrics import Family, Histogram, MetricsRegistry

RUN_STATS_PREFIX = "trees_run_"


# --------------------------------------------------------------------------
# JSONL
# --------------------------------------------------------------------------
def _sample(fam: Family, labels: Dict[str, str], child) -> dict:
    base = {"name": fam.name, "type": fam.kind, "labels": labels}
    if isinstance(child, Histogram):
        base["sum"] = child.sum
        base["count"] = child.count
        base["buckets"] = [
            {"le": le, "count": c}
            for le, c in zip(
                list(child.buckets) + ["+Inf"],
                _cumulative(child.counts),
            )
        ]
    else:
        base["value"] = child.value
    return base


def _cumulative(counts):
    total = 0
    out = []
    for c in counts:
        total += c
        out.append(total)
    return out


def iter_samples(registry: MetricsRegistry) -> Iterator[dict]:
    for fam in registry.families():
        for labels, child in fam.items():
            yield _sample(fam, labels, child)


def write_jsonl(registry: MetricsRegistry, path: str) -> int:
    """Write one sample per line; returns the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for sample in iter_samples(registry):
            f.write(json.dumps(sample, sort_keys=True))
            f.write("\n")
            n += 1
    return n


def read_jsonl(path: str):
    """Load a JSONL snapshot back into a list of sample dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------
def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format."""
    lines = []
    for fam in registry.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.items():
            if isinstance(child, Histogram):
                cum = _cumulative(child.counts)
                for le, c in zip(list(child.buckets) + [float("inf")], cum):
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_fmt_labels(labels, {'le': _fmt_value(le)})} {c}"
                    )
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(child.sum)}"
                )
                lines.append(
                    f"{fam.name}_count{_fmt_labels(labels)} {child.count}"
                )
            else:
                lines.append(
                    f"{fam.name}{_fmt_labels(labels)} "
                    f"{_fmt_value(child.value)}"
                )
    return "\n".join(lines) + "\n"


def write_prometheus(registry: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus(registry))


# --------------------------------------------------------------------------
# RunStats bridge (shared metric vocabulary)
# --------------------------------------------------------------------------
def export_run_stats(registry: MetricsRegistry, stats: RunStats,
                     **labels: str) -> None:
    """Publish a finished run's stats as ``trees_run_<key>`` gauges.

    The key set *is* ``RunStats.as_dict()`` — one source of truth for
    metric names; renaming a stats field renames it everywhere at once
    (per-type dict fields are flattened to one gauge per type)."""
    labelnames = tuple(sorted(labels))
    for key, value in stats.as_dict().items():
        if isinstance(value, dict):
            fam = registry.gauge(
                RUN_STATS_PREFIX + key, f"RunStats.{key}",
                labelnames + ("type",),
            )
            for tname, tval in value.items():
                fam.labels(**labels, type=tname).set(float(tval))
        else:
            registry.gauge(
                RUN_STATS_PREFIX + key, f"RunStats.{key}", labelnames
            ).labels(**labels).set(float(value))
