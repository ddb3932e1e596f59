"""Stall attribution: turn span aggregates into a per-pipeline verdict (the
port of ``trivy_tpu/obs/stall.py``).

Span names follow ``pipeline.stage`` (``secret.device_wait``,
``license.dispatch``). The trailing stage component maps to an attribution
bucket; for each pipeline with recorded bucketed time, the bucket shares
are normalized to exactly 100% (largest-remainder rounding) and printed as
a one-line verdict::

    secret: feed-starved 72% / device-bound 18% / confirm-bound 10%

Buckets name the *cause* a pipeline is slow:

- ``queue-bound`` — the scan sat in a server's admission queue
- ``feed-starved`` — the device loop sat waiting for host batches (walk,
  read, chunk/pack could not keep the card fed)
- ``upload-bound`` — time in dispatch (host-to-device copy and launches)
- ``device-bound`` — blocking waits on device results (kernel time)
- ``confirm-bound`` — exact host confirmation / host finalize
- ``parse-bound`` / ``eval-bound`` — misconf file parsing vs check eval

The table and the verdict are the JAX package's; pipelines of a joined
remote scan (``server:secret``) come with client/server mode, which the
port does not have yet.
"""

from __future__ import annotations

from trivy_tpu_torch.obs import TraceContext

# trailing stage-name component -> attribution bucket
BUCKETS = {
    "queue_wait": "queue-bound",  # admission-queue wait before the scan ran
    "warm_hit": "warm-hit",  # batched persistent dedup-store lookups
    "feed_wait": "feed-starved",
    "dispatch": "upload-bound",
    "compress": "codec-bound",  # host-side slab encode (compressed feed)
    "decompress": "codec-bound",  # wire-frame placement + decode launch
    "device_wait": "device-bound",
    "prefilter": "device-bound",  # blocking prefilter-result fetch
    "confirm": "confirm-bound",
    "finalize": "confirm-bound",
    "host_fallback": "confirm-bound",  # degraded-mode exact host rescans
    "parse": "parse-bound",
    "eval": "eval-bound",
}

# stable display order for verdict lines
ORDER = [
    "queue-bound",
    "warm-hit",
    "feed-starved",
    "upload-bound",
    "codec-bound",
    "device-bound",
    "confirm-bound",
    "parse-bound",
    "eval-bound",
]


def _largest_remainder_pcts(totals: dict[str, float]) -> dict[str, int]:
    """Integer percentages summing to exactly 100."""
    grand = sum(totals.values())
    if grand <= 0:
        return {}
    raw = {k: v / grand * 100.0 for k, v in totals.items()}
    floors = {k: int(v) for k, v in raw.items()}
    short = 100 - sum(floors.values())
    # hand the leftover points to the largest fractional remainders
    for k in sorted(raw, key=lambda k: raw[k] - floors[k], reverse=True)[:short]:
        floors[k] += 1
    return floors


def attribution(ctx: TraceContext) -> dict[str, dict[str, int]]:
    """pipeline -> {bucket: integer pct}; percentages sum to 100 per
    pipeline. Pipelines with no bucketed span time are omitted.

    Stage totals are normalized by the number of distinct threads that
    recorded the stage: confirm-pool spans run in N concurrent workers, so
    their raw sum is up to N times wall time while the device-loop stages
    (feed_wait/dispatch/device_wait) partition one thread's wall time.
    Dividing by the recording-thread count yields each stage's per-worker
    wall-time share, commensurable across serial and pooled stages."""
    totals: dict[str, dict[str, float]] = {}
    for name, (total, n_threads) in ctx.stage_totals().items():
        if "." not in name:
            continue
        pipeline, stage = name.split(".", 1)
        bucket = BUCKETS.get(stage.rsplit(".", 1)[-1])
        if bucket is None:
            continue
        b = totals.setdefault(pipeline, {})
        b[bucket] = b.get(bucket, 0.0) + total / max(1, n_threads)
    return {
        pipeline: pcts
        for pipeline, buckets in sorted(totals.items())
        if (pcts := _largest_remainder_pcts(buckets))
    }


def verdict_lines(ctx: TraceContext) -> list[str]:
    """One formatted verdict line per pipeline, buckets in stable order."""
    lines = []
    for pipeline, pcts in attribution(ctx).items():
        parts = [f"{b} {pcts[b]}%" for b in ORDER if b in pcts]
        lines.append(f"{pipeline}: " + " / ".join(parts))
    return lines
