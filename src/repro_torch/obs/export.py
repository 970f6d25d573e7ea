"""Prometheus text exposition + JSON snapshot for a MetricsRegistry.

``to_prometheus(registry)`` renders the standard text format (# HELP/# TYPE
headers, ``_total`` counters, histogram ``_bucket{le=...}``/``_sum``/
``_count`` series).  ``parse_prometheus(text)`` is a strict validator used by
CI (``python -m repro_torch.obs.export --check [file]``): it re-parses an export
and checks the invariants a real scraper relies on -- TYPE before samples,
ascending cumulative buckets, a ``+Inf`` bucket equal to ``_count``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys

from .registry import MetricsRegistry


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels, extra=None) -> str:
    items = list(labels) + (list(extra.items()) if extra else [])
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format."""
    ns = registry.namespace
    lines = []
    for fam in registry.families():
        name = f"{ns}_{fam.name}" if ns else fam.name
        lines.append(f"# HELP {name} {fam.help or fam.name}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for key, m in fam.children.items():
            if fam.kind == "histogram":
                cum = 0
                for bound, cnt in zip(m.bounds, m.counts[:-1]):
                    cum += int(cnt)
                    lines.append(f"{name}_bucket{_labels_str(key, {'le': _fmt(float(bound))})} {cum}")
                cum += int(m.counts[-1])
                lines.append(f"{name}_bucket{_labels_str(key, {'le': '+Inf'})} {cum}")
                lines.append(f"{name}_sum{_labels_str(key)} {repr(float(m.sum))}")
                lines.append(f"{name}_count{_labels_str(key)} {cum}")
            else:
                lines.append(f"{name}{_labels_str(key)} {_fmt(m.value)}")
    return "\n".join(lines) + "\n"


def to_json(registry: MetricsRegistry, indent=2) -> str:
    return json.dumps(registry.snapshot(), indent=indent, sort_keys=True)


# --------------------------------------------------------------------------
# Validator / parser
# --------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[-+]?(?:Inf|NaN|[0-9.eE+-]+))\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Parse + validate an exposition; raises ValueError on any violation.

    Returns {family_name: {"type": kind, "samples": [(name, labels, value)]}}.
    """
    families = {}
    typed = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4 or parts[3] not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: malformed TYPE line: {raw!r}")
            typed[parts[2]] = parts[3]
            families.setdefault(parts[2], {"type": parts[3], "samples": []})
            continue
        if line.startswith("#"):
            raise ValueError(f"line {lineno}: unknown comment form: {raw!r}")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        name = m.group("name")
        labels = {}
        lbl_body = m.group("labels")
        if lbl_body:
            consumed = "".join(f'{k}="{v}"' for k, v in _LABEL_RE.findall(lbl_body))
            if consumed.replace('","', '","') and _LABEL_RE.sub("", lbl_body).strip(", "):
                raise ValueError(f"line {lineno}: malformed labels: {lbl_body!r}")
            labels = dict(_LABEL_RE.findall(lbl_body))
        vs = m.group("value")
        value = math.inf if vs in ("+Inf", "Inf") else (-math.inf if vs == "-Inf" else float(vs))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed \
                    and typed[name[: -len(suffix)]] == "histogram":
                base = name[: -len(suffix)]
                break
        if base not in typed:
            raise ValueError(f"line {lineno}: sample {name!r} has no preceding TYPE")
        families[base]["samples"].append((name, labels, value))

    for fam_name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series = {}
        for name, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
            entry = series.setdefault(key, {"buckets": [], "sum": None, "count": None})
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise ValueError(f"{fam_name}: bucket sample missing le label")
                le = math.inf if labels["le"] == "+Inf" else float(labels["le"])
                entry["buckets"].append((le, value))
            elif name.endswith("_sum"):
                entry["sum"] = value
            elif name.endswith("_count"):
                entry["count"] = value
        for key, entry in series.items():
            buckets = entry["buckets"]
            if not buckets:
                raise ValueError(f"{fam_name}{dict(key)}: histogram with no buckets")
            les = [b[0] for b in buckets]
            if les != sorted(les) or les[-1] != math.inf:
                raise ValueError(f"{fam_name}{dict(key)}: buckets not ascending to +Inf")
            counts = [b[1] for b in buckets]
            if any(b > a for b, a in zip(counts, counts[1:])):
                raise ValueError(f"{fam_name}{dict(key)}: bucket counts not cumulative")
            if entry["count"] is None or entry["sum"] is None:
                raise ValueError(f"{fam_name}{dict(key)}: missing _sum or _count")
            if entry["count"] != counts[-1]:
                raise ValueError(f"{fam_name}{dict(key)}: _count != +Inf bucket")
    return families


def demo_registry() -> MetricsRegistry:
    """Tiny synthetic registry for self-contained --check runs (no engine,
    no jax import: usable as a CI smoke with near-zero cost)."""
    reg = MetricsRegistry(namespace="p4db")
    reg.counter("txns_committed_total", help="committed transactions").inc(42)
    reg.counter("txn_aborts_total", help="aborts").inc(3)
    reg.gauge("inflight_batches", help="in-flight async batches").set(2)
    h = reg.histogram("txn_latency_seconds", help="txn latency", klass="hot")
    for i in range(100):
        h.observe(1e-5 * (1 + (i % 17)))
    reg.histogram("txn_latency_seconds", klass="cold").observe(2e-3)
    return reg


def main(argv=None):
    ap = argparse.ArgumentParser(description="Prometheus export check / demo")
    ap.add_argument("--check", nargs="?", const="", metavar="FILE",
                    help="validate FILE (or the built-in demo export if omitted)")
    ap.add_argument("--demo", action="store_true", help="print the demo exposition")
    ap.add_argument("--json", action="store_true", help="with --demo, print JSON snapshot")
    args = ap.parse_args(argv)

    if args.demo:
        reg = demo_registry()
        sys.stdout.write(to_json(reg) + "\n" if args.json else to_prometheus(reg))
        return 0
    if args.check is not None:
        if args.check:
            with open(args.check) as f:
                text = f.read()
            src = args.check
        else:
            text = to_prometheus(demo_registry())
            src = "<demo>"
        try:
            fams = parse_prometheus(text)
        except ValueError as e:
            print(f"FAIL {src}: {e}", file=sys.stderr)
            return 1
        n_samples = sum(len(f["samples"]) for f in fams.values())
        print(f"OK {src}: {len(fams)} families, {n_samples} samples")
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
