"""Deterministic fault-injection registry (the chaos harness).

PAPER.md §7's accelerator path adds failure domains the reference never
had — device OOM, tunnel resets, preemption, dropped cache connections —
and the retry/breaker/fallback ladder that survives them needs a way to be
*proven* without real hardware faults. This registry arms scripted failures
at named sites: instrumented code calls :func:`check(site, key=...)` on its
hot path (one module-global ``None`` check when disarmed), and an armed plan
raises the scripted exception at exactly the Nth hit of that site, so chaos
tests and the bench chaos rep are deterministic and replayable.

This is the port's copy of ``trivy_tpu/faults.py``, grammar and all. Of the
sites below the port instruments ``device.dispatch`` (keys ``d0``,
``license`` and ``cve``), ``device.fetch`` (``d0``) and ``walker.read``;
the others come with the modules that hold them.

Instrumented sites (key in parentheses):

- ``device.dispatch`` (``d<i>`` per device stream, ``license`` for the
  license scorer) — host→device batch dispatch
- ``device.fetch`` (``d<i>``) — blocking device-result fetch
- ``cache.redis.get`` / ``cache.redis.set`` (cache key) — redis commands
- ``rpc.post`` (route path) — one client HTTP attempt
- ``walker.read`` (relative path) — file read between walk and analysis
- ``misconf.eval`` (file path) — per-file misconfiguration evaluation
- ``admission.enqueue`` (tenant name) — job enqueue into the server's
  admission queue (a fault here must shed loudly, never crash the server)
- ``admission.dequeue`` (tenant name) — job handoff from queue to worker
  (a fault here must fail that one job terminally, never wedge the queue)
- ``job.result.fetch`` (job id) — async job result lookup
- ``fleet.dispatch`` (replica address) — coordinator-side shard dispatch
  to one fleet replica (a fault here must re-dispatch to a survivor via
  the per-replica breaker, never fail the scan)
- ``fleet.steal`` (stealing replica address) — work-steal handoff of a
  queued shard (a fault here must requeue the shard, never lose it)
- ``fleet.result`` (shard index) — coordinator-side shard result fold (a
  fault here counts as a failed attempt and re-dispatches that one shard)
- ``fleet.register`` (joining replica address) — live replica join on the
  elastic control plane (a fault here must refuse the join loudly and
  leave the running fan-out untouched)
- ``fleet.drain`` (draining replica address) — queued-shard hand-back
  when a replica reports draining (a fault here must fall back to the
  breaker ladder — the shard re-dispatches as a plain failure, never
  lost, never double-completed)
- ``fleet.split`` (shard index) — mid-scan straggler split at a
  directory boundary (a fault here must abandon the split and leave the
  original in-flight attempt racing as before)

Spec grammar (``--fault-inject`` / ``TRIVY_TPU_FAULT_INJECT``), clauses
comma-separated::

    site[@key][:at=N][:times=M][:rate=P][:error=KIND]   |   seed=N

- ``@key``    only hits with this key fault (omitted = every key)
- ``at=N``    first faulting hit, 1-based per (site, key) counter (default 1)
- ``times=M`` consecutive faulting hits from ``at`` (default 1; -1 = forever)
- ``rate=P``  instead of at/times: fault each hit with probability P,
  decided by a keyed hash of (seed, site, key, hit#) — deterministic for a
  fixed seed, independent of thread interleaving within one (site, key)
- ``error=KIND`` — ``fault`` (RuntimeError, default), ``oom`` (an
  RESOURCE_EXHAUSTED-shaped RuntimeError the retry ladder answers with
  batch halving), ``conn`` (ConnectionError), ``io`` (OSError)

Examples::

    device.dispatch:at=3            # 3rd dispatch anywhere fails once
    device.dispatch@d3:times=-1     # device 3 is permanently dead
    device.dispatch:at=1:error=oom  # first batch OOMs (ladder must split)
    cache.redis.get:times=-1        # every redis GET fails (must degrade)
    rpc.post:rate=0.2:error=conn seed=7
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field

ENV_VAR = "TRIVY_TPU_FAULT_INJECT"


class InjectedFault(RuntimeError):
    """Generic scripted failure."""


class InjectedOom(RuntimeError):
    """RESOURCE_EXHAUSTED-shaped scripted failure (device OOM analog)."""


class InjectedConnError(ConnectionError):
    """Scripted connection failure (tunnel reset / dropped socket analog)."""


class InjectedIOError(OSError):
    """Scripted I/O failure (vanished/unreadable file analog)."""


_ERROR_KINDS = {
    "fault": lambda msg: InjectedFault(msg),
    "oom": lambda msg: InjectedOom(f"RESOURCE_EXHAUSTED: out of memory: {msg}"),
    "conn": lambda msg: InjectedConnError(msg),
    "io": lambda msg: InjectedIOError(msg),
}


@dataclass
class FaultRule:
    site: str
    key: str | None = None  # None matches every key at the site
    at: int = 1  # first faulting hit (1-based)
    times: int = 1  # consecutive faulting hits; -1 = forever
    rate: float = 0.0  # when > 0: probabilistic mode (seeded hash)
    error: str = "fault"
    fired: int = 0  # times this rule actually raised

    def should_fire(self, hit: int, key: str | None, seed: int) -> bool:
        if self.rate > 0.0:
            h = hashlib.blake2b(
                f"{seed}:{self.site}:{key or ''}:{hit}".encode(), digest_size=8
            ).digest()
            return int.from_bytes(h, "big") / float(1 << 64) < self.rate
        if hit < self.at:
            return False
        return self.times < 0 or hit < self.at + self.times


@dataclass
class FaultPlan:
    """An armed set of rules plus per-(site, key) hit counters."""

    rules: list[FaultRule] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()
        self._site_hits: dict[str, int] = {}
        self._key_hits: dict[tuple[str, str], int] = {}
        self._by_site: dict[str, list[FaultRule]] = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)

    def check(self, site: str, key: str | None = None) -> None:
        rules = self._by_site.get(site)
        err = None
        with self._lock:
            # count every visit (even unmatched sites don't need counting,
            # but a rule added for this site does)
            if rules is None:
                return
            n_site = self._site_hits[site] = self._site_hits.get(site, 0) + 1
            n_key = n_site
            if key is not None:
                kk = (site, key)
                n_key = self._key_hits[kk] = self._key_hits.get(kk, 0) + 1
            for r in rules:
                if r.key is not None and r.key != key:
                    continue
                hit = n_key if r.key is not None else n_site
                if r.should_fire(hit, key, self.seed):
                    r.fired += 1
                    err = _ERROR_KINDS[r.error](
                        f"injected fault at {site}"
                        f"{f'[{key}]' if key else ''} hit {hit}"
                    )
                    break
        if err is not None:
            # flight-recorder breadcrumb: the injected site lands in the
            # ring BEFORE the raise, so a failure bundle's machine verdict
            # names the faulted site directly
            from trivy_tpu_torch.obs import recorder as flight

            flight.record(
                "fault", f"{site}@{key}" if key else site,
                {"error": type(err).__name__},
            )
            raise err

    def fired(self) -> dict[str, int]:
        """site[@key] -> raise count, for tests and chaos-rep reporting."""
        with self._lock:
            out: dict[str, int] = {}
            for r in self.rules:
                name = r.site + (f"@{r.key}" if r.key else "")
                out[name] = out.get(name, 0) + r.fired
            return out


_OPTION_NAMES = ("at", "times", "rate", "error")


def parse(spec: str) -> FaultPlan:
    """Parse a ``--fault-inject`` spec string into a :class:`FaultPlan`.

    Options are the trailing ``:``-separated parts that start with a known
    option name, so keys containing ``:`` (redis keys like
    ``fanal::artifact::<digest>``) stay addressable:
    ``cache.redis.get@fanal::artifact::abc:times=-1`` parses as key
    ``fanal::artifact::abc``. Keys containing ``,`` are not expressible
    (it is the clause separator).
    """
    rules: list[FaultRule] = []
    seed = 0
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[5:])
            continue
        parts = clause.split(":")
        key = None
        if "@" in parts[0]:
            # only the key may contain ':' — options are the trailing parts
            # that start with a known option name
            site, key0 = parts[0].split("@", 1)
            opt_start = next(
                (
                    i
                    for i in range(1, len(parts))
                    if parts[i].split("=", 1)[0] in _OPTION_NAMES
                ),
                len(parts),
            )
            key = ":".join([key0] + parts[1:opt_start])
        else:
            site = parts[0]
            opt_start = 1
        rule = FaultRule(site=site, key=key)
        for p in parts[opt_start:]:
            if "=" not in p:
                raise ValueError(f"--fault-inject: bad clause part {p!r}")
            k, v = p.split("=", 1)
            if k == "at":
                rule.at = int(v)
            elif k == "times":
                rule.times = int(v)
            elif k == "rate":
                rule.rate = float(v)
            elif k == "error":
                if v not in _ERROR_KINDS:
                    raise ValueError(
                        f"--fault-inject: unknown error kind {v!r}; "
                        f"allowed: {sorted(_ERROR_KINDS)}"
                    )
                rule.error = v
            else:
                raise ValueError(f"--fault-inject: unknown option {k!r}")
        if rule.at < 1:
            raise ValueError("--fault-inject: at must be >= 1")
        rules.append(rule)
    return FaultPlan(rules=rules, seed=seed)


# the armed plan; None = disarmed (the hot-path fast case)
_PLAN: FaultPlan | None = None


def configure(spec: str | FaultPlan | None) -> FaultPlan | None:
    """Arm a plan from a spec string (or an explicit plan). ``None``/empty
    disarms. Returns the armed plan."""
    global _PLAN
    if spec is None or spec == "":
        _PLAN = None
    elif isinstance(spec, FaultPlan):
        _PLAN = spec
    else:
        _PLAN = parse(spec)
    return _PLAN


def configure_from_env() -> FaultPlan | None:
    """Arm from ``TRIVY_TPU_FAULT_INJECT`` when set (harness processes that
    never pass CLI flags, e.g. the bench chaos child)."""
    spec = os.environ.get(ENV_VAR)
    return configure(spec) if spec else _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None


def active() -> bool:
    return _PLAN is not None


def plan() -> FaultPlan | None:
    return _PLAN


def check(site: str, key: str | None = None) -> None:
    """Raise the scripted failure if an armed rule matches this hit.

    The disarmed fast path is one global read — cheap enough for per-file
    and per-batch call sites.
    """
    p = _PLAN
    if p is not None:
        p.check(site, key)
