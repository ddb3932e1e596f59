"""Per-rule / per-bucket cost attribution for one scan, the "scan profile"
(the port of ``trivy_tpu/obs/profile.py``).

The stall verdict (:mod:`trivy_tpu_torch.obs.stall`) says *which stage* of a
pipeline is slow; this module says *which rule* and *which dispatch bucket*.

Recorded per rule id:

- ``gate_hits`` — device matcher hits ((row, rule) pairs the kernels
  flagged, rows served from the dedup store included: a cached hit still
  costs a confirm)
- ``confirms`` / ``confirm_s`` — exact host confirmations run for the rule
  and their wall time
- ``findings`` — locations that survived confirmation
- ``wasted_confirms`` / ``wasted_confirm_s`` — confirms that found nothing;
  ``fp_rate`` = wasted / confirms
- ``prefilter_hits`` — rows on which the keyword prefilter made the rule a
  candidate

Recorded per dispatch bucket (the secret feed's batch-shape rungs
``"1024"``, ``"512"``, ...; ``"license.gate:<rows>x<width>x<shards>"`` and
``"license.score:..."`` for the classifier): dispatches, rows, and the
seconds of the blocking fetch of the results.

A :class:`ScanProfile` lives on a :class:`trivy_tpu_torch.obs.TraceContext`
(created lazily by ``ctx.profile()``). The fleet's per-shard rows and
``fleet_table_lines`` come with the fleet, which the port does not have.
"""

from __future__ import annotations

import threading

# bound on the rules the report table lists (the JAX default);
# --profile-out keeps them all
TOP_K = 10


class ScanProfile:
    """Thread-safe per-rule and per-bucket accumulators for one scan."""

    def __init__(self):
        self._lock = threading.Lock()
        # rule -> [gate_hits, confirms, confirm_s, findings, wasted_confirms,
        # wasted_confirm_s, prefilter_hits]
        self._rules: dict[str, list] = {}
        self._buckets: dict[str, list] = {}  # key -> [dispatches, rows, wait_s]
        # prefilter pass totals: [rows inspected, rows whose batch skipped
        # the anchored matcher, rows with >=1 candidate rule]
        self._pre = [0, 0, 0]

    def _rule(self, rule_id: str) -> list:
        r = self._rules.get(rule_id)
        if r is None:
            r = self._rules[rule_id] = [0, 0, 0.0, 0, 0, 0.0, 0]
        return r

    # -- recording ----------------------------------------------------------

    def gate_hit(self, rule_id: str, n: int = 1) -> None:
        """The device matcher flagged ``rule_id`` on ``n`` rows."""
        with self._lock:
            self._rule(rule_id)[0] += n

    def prefilter_hit(self, rule_id: str, n: int = 1) -> None:
        """The keyword prefilter made ``rule_id`` a candidate on ``n`` rows."""
        with self._lock:
            self._rule(rule_id)[6] += n

    def prefilter_rows(self, rows: int, skipped: int, hit_rows: int = 0) -> None:
        """The prefilter inspected ``rows`` more rows, of which ``skipped``
        rode a batch that skipped the anchored matcher and ``hit_rows``
        carried at least one candidate rule."""
        with self._lock:
            self._pre[0] += rows
            self._pre[1] += skipped
            self._pre[2] += hit_rows

    def confirm(self, rule_id: str, seconds: float, findings: int) -> None:
        """One exact host evaluation of ``rule_id`` took ``seconds`` and
        yielded ``findings`` surviving locations."""
        with self._lock:
            r = self._rule(rule_id)
            r[1] += 1
            r[2] += seconds
            r[3] += findings
            if findings == 0:
                r[4] += 1
                r[5] += seconds

    def bucket_dispatch(self, bucket, rows: int, wait_s: float) -> None:
        """One dispatch of ``rows`` live rows in shape-bucket ``bucket``
        spent ``wait_s`` in the blocking result fetch."""
        key = str(bucket)
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = [0, 0, 0.0]
            b[0] += 1
            b[1] += rows
            b[2] += wait_s

    # -- serialization ------------------------------------------------------

    def to_dict(self, top_k: int | None = None) -> dict:
        """JSON-serializable profile; rules hottest first (confirm time,
        then gate hits). ``top_k`` bounds the rule list; None keeps all."""
        with self._lock:
            rules = {k: list(v) for k, v in self._rules.items()}
            buckets = {k: list(v) for k, v in self._buckets.items()}
            pre_rows, pre_skipped, pre_hit_rows = self._pre
        items = sorted(rules.items(), key=lambda kv: (-kv[1][2], -kv[1][0], kv[0]))
        if top_k is not None:
            items = items[:top_k]
        doc = {
            "rules": {
                rid: {
                    "gate_hits": g,
                    "confirms": c,
                    "confirm_ms": round(cs * 1e3, 3),
                    "findings": f,
                    "wasted_confirms": wc,
                    "wasted_confirm_ms": round(wcs * 1e3, 3),
                    "fp_rate": round(wc / c, 4) if c else 0.0,
                    "prefilter_hits": p,
                    # the share of all prefiltered rows this rule's
                    # keywords flagged
                    "prefilter_selectivity": round(p / pre_rows, 6) if pre_rows else 0.0,
                }
                for rid, (g, c, cs, f, wc, wcs, p) in items
            },
            "buckets": {
                k: {"dispatches": d, "rows": rows, "device_wait_ms": round(s * 1e3, 3)}
                for k, (d, rows, s) in sorted(buckets.items())
            },
        }
        if pre_rows:
            doc["prefilter"] = {
                "rows": pre_rows,
                "rows_nfa_skipped": pre_skipped,
                "hit_rows": pre_hit_rows,
                # the share of rows carrying >=1 candidate rule
                "selectivity": round(pre_hit_rows / pre_rows, 6),
            }
        return doc


def top_rules(doc: dict, k: int | None = None) -> list[tuple[str, dict]]:
    """Hottest rules of a serialized profile: by confirm time, then gate
    hits. ``k`` defaults to :data:`TOP_K`."""
    items = sorted(
        (doc.get("rules") or {}).items(),
        key=lambda kv: (-kv[1].get("confirm_ms", 0.0), -kv[1].get("gate_hits", 0), kv[0]),
    )
    return items[: TOP_K if k is None else k]


def table_lines(doc: dict, k: int | None = None) -> list[str]:
    """Formatted top-K "hottest rules" table for the --trace report."""
    rows = top_rules(doc, k)
    if not rows:
        return []
    lines = [
        f"{'rule':<34}{'gate_hits':>10}{'confirms':>9}{'confirm':>10}"
        f"{'fp%':>7}{'wasted':>10}{'found':>6}"
    ]
    for rid, f in rows:
        lines.append(
            f"{rid:<34}{f.get('gate_hits', 0):>10}{f.get('confirms', 0):>9}"
            f"{f.get('confirm_ms', 0.0):>8.1f}ms"
            f"{100.0 * f.get('fp_rate', 0.0):>6.1f}%"
            f"{f.get('wasted_confirm_ms', 0.0):>8.1f}ms"
            f"{f.get('findings', 0):>6}"
        )
    return lines
