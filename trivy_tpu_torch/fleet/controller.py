"""Fleet placement controller: headroom-weighted dispatch (the port of
``trivy_tpu/fleet/controller.py``).

The telemetry poller (:mod:`trivy_tpu_torch.fleet.telemetry`) scores each
replica's headroom in [0, 1]; a :class:`FleetController` maps it to a
quantized **placement weight** that the coordinator's affinity queues
consult: requeue targets minimize *weighted* queued bytes (``queued_bytes /
weight``), and steal donors rank by the same weighted load, so a replica
the gauges say is drowning sheds work to one with headroom to spare.

Stability comes from the tuning controller's machinery, per replica:

- **quantization**: weights move on a ladder of :data:`WEIGHT_STEP` rungs
  between :data:`MIN_WEIGHT` and :data:`MAX_WEIGHT`;
- **dead band**: a re-weight is only proposed when the raw headroom sits
  more than half a rung plus :data:`DEAD_BAND` away from the current weight;
- **hysteresis**: a proposal must repeat for
  :data:`~trivy_tpu_torch.tuning.HYSTERESIS_TICKS` ticks before it fires;
- **cooldown**: a fired re-weight holds that replica's weight for
  :data:`~trivy_tpu_torch.tuning.COOLDOWN_TICKS` ticks.

So a feed whose per-replica noise stays within the dead band reaches a
fixed point and never fires again, and the decision log replays: the
per-replica deltas sum to ``final - initial``.

The controller is tickless: it owns no thread. The poller's scrape loop
calls :meth:`tick`, so its cadence is ``--fleet-telemetry-interval``, and a
fleet scan with telemetry off never builds one. Decisions land in the
decision log (``doc()``, in the scan's ``fleet`` block), the scan's time
series (per-replica ``fleet.weight.*`` counter tracks) and the
``trivy_tpu_fleet_weight{replica=}`` gauge the poller exports.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from trivy_tpu_torch import log
from trivy_tpu_torch.tuning import COOLDOWN_TICKS, HYSTERESIS_TICKS, MAX_DECISIONS

logger = log.logger("fleet:controller")

# the weight ladder: coarse on purpose (placement only needs "roughly half
# or a quarter of a fair share"), which is what makes the dead band mean
# something
WEIGHT_STEP = 0.25
MIN_WEIGHT = 0.25  # a breaker-open replica is excluded by the breaker,
MAX_WEIGHT = 1.0   # not by a zero weight: weights only bias placement
# margin past a rung's half-width before a re-weight is even proposed
DEAD_BAND = 0.05

# the decision-log schema at fleet level (``gauges`` is the whole headroom
# snapshot the decision was made from, so the log replays alone)
FLEET_DECISION_FIELDS = ("t", "rule", "knob", "from", "to", "gauges")


def quantize_weight(headroom: float) -> float:
    """The nearest weight rung for a headroom score, clamped to the ladder."""
    h = min(1.0, max(0.0, headroom))
    q = round(h / WEIGHT_STEP) * WEIGHT_STEP
    return round(min(MAX_WEIGHT, max(MIN_WEIGHT, q)), 2)


class FleetController:
    """One fan-out's headroom -> placement-weight controller (tickless; the
    telemetry poller drives :meth:`tick` on its scrape cadence)."""

    def __init__(self, hosts, ctx=None, interval: float | None = None, on_weights=None):
        self.ctx = ctx
        self.interval = float(interval or 0.0)
        self.on_weights = on_weights  # callback(weights dict) on a fired decision
        self.ticks = 0
        self._lock = threading.Lock()
        self._weights: dict[str, float] = {h: MAX_WEIGHT for h in hosts}
        self._initial: dict[str, float] = dict(self._weights)
        self._pending: dict[str, float] = {}  # host -> proposed rung
        self._streak: dict[str, int] = {}     # host -> consecutive ticks
        self._cooldown: dict[str, int] = {}   # host -> ticks remaining
        self.decisions: deque = deque(maxlen=MAX_DECISIONS)
        self.dropped = 0

    def weights(self) -> dict[str, float]:
        with self._lock:
            return dict(self._weights)

    def add_host(self, host: str) -> None:
        """A replica joined mid-sweep: it enters at full weight, and the
        initial snapshot grows so that the replay stays exact."""
        with self._lock:
            if host in self._weights:
                return
            self._weights[host] = MAX_WEIGHT
            self._initial[host] = MAX_WEIGHT

    def step(self, headrooms: dict[str, float], t: float | None = None) -> list[dict]:
        """One control tick over ``{host: headroom}``; returns the decisions
        fired (usually none). A host absent from the snapshot holds its
        weight: no data is not headroom 0."""
        self.ticks += 1
        if t is None:
            t = self.ticks * (self.interval or 1.0)
        fired: list[dict] = []
        with self._lock:
            for host, h in headrooms.items():
                if host not in self._weights:
                    continue  # not registered yet (a join racing a scrape)
                cur = self._weights[host]
                if self._cooldown.get(host, 0) > 0:
                    self._cooldown[host] -= 1
                    self._pending.pop(host, None)
                    self._streak.pop(host, None)
                    continue
                cand = quantize_weight(h)
                # the dead band: inside the current rung's half-width plus the
                # margin nothing is proposed
                if cand == cur or abs(h - cur) <= WEIGHT_STEP / 2 + DEAD_BAND:
                    self._pending.pop(host, None)
                    self._streak.pop(host, None)
                    continue
                if self._pending.get(host) != cand:
                    self._pending[host] = cand
                    self._streak[host] = 1
                    continue
                self._streak[host] += 1
                if self._streak[host] < HYSTERESIS_TICKS:
                    continue
                # fire: one rung assignment, then hold still
                self._pending.pop(host, None)
                self._streak.pop(host, None)
                self._cooldown[host] = COOLDOWN_TICKS
                d = {
                    "t": round(t, 3),
                    "rule": "reweight",
                    "knob": f"weight:{host}",
                    "from": cur,
                    "to": cand,
                    "gauges": {hh: round(float(vv), 4) for hh, vv in sorted(headrooms.items())},
                }
                if len(self.decisions) == self.decisions.maxlen:
                    self.dropped += 1
                self.decisions.append(d)
                self._weights[host] = cand
                fired.append(d)
            weights = dict(self._weights) if fired else None
        if fired:
            if self.on_weights is not None:
                self.on_weights(weights)
            for d in fired:
                logger.info("fleet placement: %s %.2f -> %.2f (headroom %.3f)", d["knob"],
                            d["from"], d["to"],
                            d["gauges"].get(d["knob"].split(":", 1)[1], 0.0))
        return fired

    def tick(self, headrooms: dict[str, float]) -> list[dict]:
        """One live tick from the poller: decide, then mirror the weights to
        the scan's time series (per-replica ``fleet.weight.*`` tracks)."""
        ctx = self.ctx
        t = None
        if ctx is not None:
            t = time.perf_counter() - ctx.created
        fired = self.step(headrooms, t)
        if ctx is not None and ctx.enabled:
            ts = ctx.timeseries
            if ts is not None:
                with self._lock:
                    snap = dict(self._weights)
                for host, w in snap.items():
                    ts.record(f"fleet.weight.{host}", t or 0.0, w)
            for _ in fired:
                ctx.count("fleet.placement_decisions")
        return fired

    def doc(self) -> dict:
        """The decision-log snapshot for the fleet block; each replica's
        deltas in ``decision_log`` sum exactly to ``final - initial``."""
        with self._lock:
            out = {
                "interval": self.interval,
                "ticks": self.ticks,
                "initial": dict(self._initial),
                "final": dict(self._weights),
                "decisions": len(self.decisions) + self.dropped,
                "decision_log": [dict(d) for d in self.decisions],
            }
            if self.dropped:
                out["dropped"] = self.dropped
        return out
