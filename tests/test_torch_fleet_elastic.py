"""The port's elastic fleet plane (``trivy_tpu_torch/fleet/controller.py``
and the coordinator's verdicts, weights and live join in
``fleet/coordinator.py``) held against the JAX package's.

- The placement controller: ``quantize_weight`` over a grid, ``step`` and
  ``tick`` on the same seeded headroom sequences (a replica joining mid
  stream) with equal weights and decision logs, and the hysteresis, dead
  band, cooldown, absent-host and replay invariants in both packages.
- Weighted placement: ``_weighted_target_locked`` and the steal donor order
  pick the JAX indices on the same queues and weights.
- The poller's verdicts: two failed scrapes dead-mark a replica and trip
  its breaker (one does not), a dead-marked replica's result poll abandons
  at once, a scrape or answer clears the mark, and a draining gauge hands
  the replica's queue back; streaks and marks equal the JAX poller's.
- The live join: ``POST /fleet/register`` with its token, a duplicate, a
  bad body, a dead or draining joiner, the ``fleet.register`` fault site,
  a join in the middle of a sweep that steals work (counters equal to the
  JAX coordinator's on the same script), and an idempotent deregister that
  hands the queue back.

Servers run in-process on the CPU; no ``fleet-*`` thread outlives a test.
"""

import threading
import time

import numpy as np
import pytest

from tests.test_torch_fleet_coordinator import (
    WAIT,
    port_fleet_scan,
    port_fs_plan,
    port_single,
    recording,
    replica,
)
from tests.test_torch_fleet_replica import env, results, shutdown  # noqa: F401
from tests.test_torch_fleet_replica import fleet_scan as jax_fleet_scan
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import faults as jax_faults
from trivy_tpu import obs as jax_obs
from trivy_tpu.fleet import FleetError as JaxFleetError
from trivy_tpu.fleet import controller as jax_controller
from trivy_tpu.fleet import plan as jax_plan
from trivy_tpu.fleet import telemetry as jax_telemetry
from trivy_tpu.fleet.coordinator import FleetConfig as JaxFleetConfig
from trivy_tpu.fleet.coordinator import FleetCoordinator as JaxFleetCoordinator
from trivy_tpu.fleet.coordinator import _ShardState as JaxShardState
from trivy_tpu.fleet.merge import FleetArtifact as JaxFleetArtifact
from trivy_tpu.obs.timeseries import Timeseries as JaxTimeseries
from trivy_tpu.parallel import mesh as jax_mesh
from trivy_tpu.rpc.client import RPCError as JaxRPCError
from trivy_tpu.rpc.client import post_register as jax_post_register
from trivy_tpu.scanner import ScanOptions as JaxScanOptions
from trivy_tpu.tuning import COOLDOWN_TICKS as JAX_COOLDOWN_TICKS
from trivy_tpu_torch import faults, obs
from trivy_tpu_torch.fleet import FleetError, controller, plan, telemetry
from trivy_tpu_torch.fleet.coordinator import FleetConfig, FleetCoordinator, _ShardState
from trivy_tpu_torch.obs.timeseries import Timeseries
from trivy_tpu_torch.parallel import mesh
from trivy_tpu_torch.rpc.client import RPCError, post_deregister, post_register
from trivy_tpu_torch.scanner import ScanOptions
from trivy_tpu_torch.tuning import COOLDOWN_TICKS, HYSTERESIS_TICKS

DEAD = "127.0.0.1:9"  # nothing listens there


@pytest.fixture(autouse=True)
def nothing_outlives_the_test():
    """Faults disarmed, the process-global breaker gauges put back, and no
    fleet thread left."""
    gauges = [jax_mesh._BREAKER_OPEN, mesh._BREAKER_OPEN]
    saved = [dict(g._values) for g in gauges]
    yield
    faults.clear()
    jax_faults.clear()
    for g, rows in zip(gauges, saved):
        with g._lock:
            g._values.clear()
            g._values.update(rows)
    left = [t.name for t in threading.enumerate() if t.name.startswith("fleet-")]
    assert not left, left


def coordinators(hosts, **cfg_kw):
    """A port and a JAX coordinator over the same replicas."""
    cfg_kw.setdefault("telemetry_interval", 0.0)
    return (FleetCoordinator(FleetConfig(hosts=list(hosts), **cfg_kw),
                             ScanOptions(scanners=["secret"])),
            JaxFleetCoordinator(JaxFleetConfig(hosts=list(hosts), **cfg_kw),
                                JaxScanOptions(scanners=["secret"])))


def shard(state_cls, spec_cls, index: int, nbytes: int):
    return state_cls(spec_cls(index=index, kind="fs", nbytes=nbytes, wire={"Kind": "fs"}))


PAIRS = ((_ShardState, plan.ShardSpec), (JaxShardState, jax_plan.ShardSpec))


# -- the placement controller ------------------------------------------------------


def test_constants_equal_jax():
    assert (controller.WEIGHT_STEP, controller.MIN_WEIGHT, controller.MAX_WEIGHT,
            controller.DEAD_BAND, controller.FLEET_DECISION_FIELDS, COOLDOWN_TICKS) == (
        jax_controller.WEIGHT_STEP, jax_controller.MIN_WEIGHT, jax_controller.MAX_WEIGHT,
        jax_controller.DEAD_BAND, jax_controller.FLEET_DECISION_FIELDS, JAX_COOLDOWN_TICKS)
    assert telemetry.DEAD_SCRAPE_STREAK == jax_telemetry.DEAD_SCRAPE_STREAK == 2
    assert telemetry._FLEET_GAUGE_SPECS == jax_telemetry._FLEET_GAUGE_SPECS
    assert telemetry._SCRAPE_FOLD == jax_telemetry._SCRAPE_FOLD


def test_quantize_weight_equals_jax():
    ladder = {0.25, 0.5, 0.75, 1.0}
    for h in np.linspace(-0.5, 1.5, 801):
        got = controller.quantize_weight(float(h))
        assert got == jax_controller.quantize_weight(float(h)) and got in ladder, h


def headroom_stream(seed: int, n: int = 60):
    """Seeded snapshots over r0..r2: each replica's level moves now and then,
    with noise around it; r2 joins at tick 25, and a replica sometimes
    misses a tick. Values are rounded as ``headroom()`` rounds them."""
    rng = np.random.default_rng(seed)
    levels = rng.choice([0.1, 0.3, 0.5, 0.7, 0.95], size=3)
    for k in range(n):
        if rng.random() < 0.1:
            levels[rng.integers(0, 3)] = rng.choice([0.1, 0.3, 0.5, 0.7, 0.95])
        hosts = ["r0", "r1"] + (["r2"] if k >= 25 else [])
        snap = {h: round(float(np.clip(levels[j] + rng.normal(0, 0.08), 0, 1)), 4)
                for j, h in enumerate(hosts) if rng.random() > 0.1}
        yield k, snap


def replays(doc: dict) -> bool:
    deltas: dict[str, float] = {}
    for d in doc["decision_log"]:
        host = d["knob"].split(":", 1)[1]
        deltas[host] = deltas.get(host, 0.0) + (d["to"] - d["from"])
    return all(round(doc["initial"][h] + deltas.get(h, 0.0), 6) == w
               for h, w in doc["final"].items())


@pytest.mark.parametrize("seed", range(8))
def test_controller_steps_equal_jax(seed):
    mine = controller.FleetController(["r0", "r1"], interval=0.5)
    ref = jax_controller.FleetController(["r0", "r1"], interval=0.5)
    fired = 0
    for k, snap in headroom_stream(seed):
        if k == 25:
            mine.add_host("r2")
            ref.add_host("r2")
        got = mine.step(snap)
        assert got == ref.step(snap) and mine.weights() == ref.weights()
        for d in got:
            assert tuple(d) == controller.FLEET_DECISION_FIELDS
            assert d["gauges"] == dict(sorted(snap.items()))
        fired += len(got)
    doc = mine.doc()
    assert doc == ref.doc() and doc["decisions"] == fired > 0 and replays(doc)


def invariant_hysteresis(mod):
    c = mod.FleetController(["r0"])
    assert c.step({"r0": 0.2}) == []  # proposed, streak 1
    for _ in range(10):
        assert c.step({"r0": 1.0}) == []  # the outlier cleared
    assert c.weights() == {"r0": mod.MAX_WEIGHT} and not c.decisions


def invariant_fixed_point(mod):
    c = mod.FleetController(["r0", "r1"])
    fired = [d for _ in range(40) for d in c.step({"r0": 0.2, "r1": 0.95})]
    assert len(fired) == 1
    assert (fired[0]["knob"], fired[0]["from"], fired[0]["to"]) == ("weight:r0", 1.0, 0.25)
    assert c.weights() == {"r0": 0.25, "r1": 1.0}


def invariant_dead_band(mod):
    c = mod.FleetController(["r0"])
    amp = mod.WEIGHT_STEP / 2 + mod.DEAD_BAND  # the boundary, inclusive
    for h in [1.0, 1.0 - amp, 1.0, 1.0 - amp / 2] * 15:
        assert c.step({"r0": h}) == []
    assert c.weights() == {"r0": mod.MAX_WEIGHT}


def invariant_cooldown(mod):
    c = mod.FleetController(["r0"])
    c.step({"r0": 0.2})
    assert len(c.step({"r0": 0.2})) == 1
    for _ in range(COOLDOWN_TICKS):  # an opposite feed holds still
        assert c.step({"r0": 1.0}) == [] and c.weights()["r0"] == 0.25
    for _ in range(HYSTERESIS_TICKS):
        c.step({"r0": 1.0})
    assert c.weights()["r0"] == mod.MAX_WEIGHT


def invariant_absent_host(mod):
    c = mod.FleetController(["r0", "r1"])
    for _ in range(5):
        c.step({"r0": 0.2})
    assert c.weights()["r1"] == mod.MAX_WEIGHT
    c.add_host("r1")  # a duplicate join changes nothing
    assert c.doc()["initial"] == {"r0": 1.0, "r1": 1.0}


def invariant_tick_counts_on_the_context(mod):
    scan_context = (obs if mod is controller else jax_obs).scan_context
    with scan_context(name="ctrl", enabled=True) as ctx:
        ctx.timeseries = Timeseries() if mod is controller else JaxTimeseries()
        c = mod.FleetController(["r0"], ctx=ctx, interval=0.05)
        c.tick({"r0": 0.2})
        c.tick({"r0": 0.2})
        assert c.weights()["r0"] == 0.25 and len(c.decisions) == 1
        assert ctx.counters["fleet.placement_decisions"] == 1
        assert ctx.timeseries.latest("fleet.weight.r0") == 0.25


@pytest.mark.parametrize("invariant", [invariant_hysteresis, invariant_fixed_point,
                                       invariant_dead_band, invariant_cooldown,
                                       invariant_absent_host,
                                       invariant_tick_counts_on_the_context])
@pytest.mark.parametrize("mod", [controller, jax_controller], ids=["port", "jax"])
def test_controller_invariants(mod, invariant):
    invariant(mod)


# -- weighted placement ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_weighted_placement_picks_the_jax_indices(seed):
    """The same queues and weights: every candidate set's weighted target
    and every replica's take (steal donor order included) equal."""
    rng = np.random.default_rng(seed)
    hosts = [f"127.0.0.1:{1 + j}" for j in range(4)]
    sizes = [[int(b) for b in rng.integers(1, 500, size=rng.integers(0, 4))] for _ in hosts]
    weights = {h: float(rng.choice([0.25, 0.5, 0.75, 1.0])) for h in hosts}
    picks = []
    for coord, (state_cls, spec_cls) in zip(coordinators(hosts, speculate=0.0,
                                                         split_threshold=0.0), PAIRS):
        coord.apply_placement(weights, fired=2)
        got = []
        for i in range(len(hosts)):
            coord._queues = [sorted((shard(state_cls, spec_cls, 10 * j + k, b)
                                     for k, b in enumerate(q)), key=lambda s: -s.spec.nbytes)
                             for j, q in enumerate(sizes)]
            coord._shards = [s for q in coord._queues for s in q]
            with coord._lock:
                targets = [coord._weighted_target_locked(c)
                           for c in ([0, 1, 2, 3], [1, 2], [0, 3], [2])]
                took, how = coord._take_locked(i)
            got.append((targets, took.spec.index if took else None, how))
        picks.append((got, coord.stats["steals"], coord.stats["placement_decisions"]))
    assert picks[0] == picks[1]


def test_a_drowning_replica_sheds_first():
    """Equal stealable shards: the down-weighted donor is robbed first, and
    new placement goes to the full-weight replica."""
    hosts = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    for coord, (state_cls, spec_cls) in zip(coordinators(hosts), PAIRS):
        drowning, healthy = shard(state_cls, spec_cls, 0, 100), shard(state_cls, spec_cls, 1, 100)
        coord._queues = [[drowning], [healthy], []]
        coord._shards = [drowning, healthy]
        coord.apply_placement({hosts[0]: 0.25, hosts[1]: 1.0, hosts[2]: 1.0})
        with coord._lock:
            assert coord._weighted_target_locked([0, 1]) == 1
            assert coord._take_locked(2) == (drowning, "steal")


# -- the poller's verdicts ---------------------------------------------------------


def test_dead_scrapes_trip_the_breaker_as_jax():
    """Replica 1 is closed: one failed scrape marks nothing, the second
    dead-marks it and trips its breaker, its result poll abandons at once,
    and a successful answer clears the mark; the live replica stays healthy.
    Streaks, marks and breakers equal the JAX poller's at each step."""
    httpd, live = replica("port")
    gone_httpd, gone = replica("port")
    gone_httpd.shutdown()
    gone_httpd.server_close()
    try:
        seen = []
        for coord, mod, (state_cls, spec_cls), scan_context, rpc_error in zip(
                coordinators([live, gone], rpc_retries=0, rpc_deadline=1.0),
                (telemetry, jax_telemetry), PAIRS, (obs.scan_context, jax_obs.scan_context),
                (RPCError, JaxRPCError)):
            with scan_context(name="dead-scrape") as ctx:
                poller = mod.ReplicaPoller(coord, ctx, interval=0.05)
                steps = []
                try:
                    for _ in range(mod.DEAD_SCRAPE_STREAK):
                        poller.scrape_once()
                        steps.append((dict(poller._dead_streaks), list(coord._dead_marks),
                                      coord.breaker.open_devices()))
                    s = shard(state_cls, spec_cls, 0, 10)
                    with pytest.raises(rpc_error, match="declared dead"):
                        if mod is telemetry:
                            coord._poll_result(1, s, "deadbeef")
                        else:
                            coord._poll_result_inner(1, s, "deadbeef", ctx, coord.drivers[1],
                                                     rpc_error)
                    assert coord.active_jobs(gone) == []
                    coord.note_replica_alive(1)
                    steps.append(list(coord._dead_marks))
                    health = poller.health[gone]
                    steps.append((health.scrapes, health.scrape_failures, health.headroom()))
                finally:
                    poller.stop()
            seen.append(steps)
    finally:
        shutdown([httpd])
    assert seen[0] == seen[1]
    assert seen[0][0] == ({live: 0, gone: 1}, [False, False], [])
    assert seen[0][1] == ({live: 0, gone: 2}, [False, True], [1])
    assert seen[0][2] == [False, False]


def test_a_draining_gauge_hands_the_queue_back():
    """Replica 0 answers ``/metrics`` while draining: one scrape hands its
    queued shard to replica 1, as the JAX poller does."""
    servers = [replica("port"), replica("port")]
    servers[0][0].service.draining = True
    hosts = [h for _, h in servers]
    try:
        for coord, mod, (state_cls, spec_cls) in zip(coordinators(hosts),
                                                     (telemetry, jax_telemetry), PAIRS):
            s = shard(state_cls, spec_cls, 0, 10)
            coord._queues, coord._shards = [[s], []], [s]
            poller = mod.ReplicaPoller(coord, obs.TraceContext(), interval=0.05)
            try:
                poller.scrape_once()
                assert coord._draining == [True, False] and coord._queues == [[], [s]]
                assert coord.stats["drains"] == 1
            finally:
                poller.stop()
    finally:
        servers[0][0].service.draining = False
        shutdown([h for h, _ in servers])


# -- the live join -----------------------------------------------------------------


def test_register_round_trip_token_and_duplicate():
    """A port server carrying each package's coordinator's hook: 404
    without a hook, 403 on a wrong token, the joiner adopted with every
    per-replica list grown, a duplicate answering ``Known``, a bad body 400;
    the answers equal the JAX seam's."""
    (front, front_host), (r0, host0), (joiner, joiner_host) = (replica("port") for _ in range(3))
    try:
        with pytest.raises(RPCError, match="404"):
            post_register(front_host, joiner_host, retries=0)
        answers = []
        for coord, post in zip(coordinators([host0]), (post_register, jax_post_register)):
            front.service.fleet_register_hook = coord.register_replica
            front.service.fleet_register_token = "sekrit"
            with pytest.raises(Exception, match="403"):
                post(front_host, joiner_host, token="wrong", retries=0)
            assert coord.stats["joins"] == 0
            first = post(front_host, joiner_host, token="sekrit")
            dup = post(front_host, joiner_host, token="sekrit")
            with pytest.raises(Exception, match="400"):
                post(front_host, "", token="sekrit", retries=0)
            assert coord.cfg.hosts == [host0, joiner_host] and coord.stats["joins"] == 1
            assert (len(coord.drivers), coord.breaker.n, len(coord._draining),
                    len(coord._dead_marks), len(coord._sync_only)) == (2, 2, 2, 2, 2)
            assert coord._weights[joiner_host] == 1.0
            answers.append((first, dup))
    finally:
        front.service.fleet_register_hook = None
        shutdown([front, r0, joiner])
    assert answers[0] == answers[1]
    assert answers[0] == ({"Host": joiner_host, "Known": False, "Replicas": 2},
                          {"Host": joiner_host, "Known": True, "Replicas": 2})


@pytest.mark.parametrize("how", ["dead", "draining", "fault", "two-addresses"])
def test_a_bad_joiner_is_refused(how):
    """A dead joiner (a ``FleetError`` from the hook, 502 on the wire), a
    draining one, a ``fleet.register`` fault (consumed: the retry joins) and
    a value naming two replicas are refused in both packages, and the
    running fleet is untouched."""
    servers = [replica("port"), replica("port"), replica("port")]
    (front, front_host), (_, host0), (joiner, joiner_host) = servers
    target = {"dead": DEAD, "two-addresses": f"{joiner_host},{host0}"}.get(how, joiner_host)
    if how == "draining":
        joiner.service.draining = True
    try:
        for coord, err, fmod in zip(coordinators([host0]), (FleetError, JaxFleetError),
                                    (faults, jax_faults)):
            if how == "fault":
                fmod.configure(f"fleet.register@{joiner_host}:at=1:times=1")
            with pytest.raises(Exception) as exc:
                coord.register_replica(target)
            assert coord.cfg.hosts == [host0] and coord.stats["joins"] == 0
            if how == "dead":
                assert isinstance(exc.value, err) and "health probe" in str(exc.value)
                front.service.fleet_register_hook = coord.register_replica
                with pytest.raises(RPCError, match="502"):
                    post_register(front_host, DEAD, retries=0)
            elif how == "draining":
                assert isinstance(exc.value, err) and "draining" in str(exc.value)
            elif how == "fault":
                assert coord.register_replica(joiner_host)["Known"] is False
                assert coord.stats["joins"] == 1
            else:
                assert isinstance(exc.value, err) and "exactly one" in str(exc.value)
    finally:
        joiner.service.draining = False
        front.service.fleet_register_hook = None
        shutdown([h for h, _ in servers])


def join_script(pkg: str, n_shards: int):
    """Replica 0 holds its one shard until the joiner has run the rest, all
    stolen from replica 0's queue. Returns the servers, a release callable
    and the joiner thread's target."""
    release = threading.Event()
    done = []

    def count(req):
        done.append(1)
        if len(done) >= n_shards - 1:
            release.set()

    servers = [replica(pkg, before=lambda req: release.wait(WAIT)), replica(pkg, after=count)]
    return servers, release


def run_join(env, pkg: str, n_shards: int) -> tuple[list, dict, dict]:
    built: list = []
    servers, release = join_script(pkg, n_shards)
    host0, joiner = servers[0][1], servers[1][1]
    joined = []

    def join():
        deadline = time.monotonic() + WAIT
        while not (built and built[0].coordinator is not None
                   and built[0].coordinator.stats["dispatches"] >= 1):
            if time.monotonic() > deadline:
                return
            time.sleep(0.01)
        joined.append(built[0].coordinator.register_replica(joiner))

    th = threading.Thread(target=join, daemon=True, name="join-script")
    cfg = dict(inflight=1, shards_per_replica=n_shards, split_threshold=0.0,
               telemetry_interval=0.05)
    try:
        th.start()
        if pkg == "port":
            with obs.scan_context(name="join", enabled=True) as ctx:
                report, _, art = port_fleet_scan(env, "fs", [host0], built=built, **cfg)
        else:
            with jax_obs.scan_context(name="join", enabled=True) as ctx, \
                    recording(JaxFleetArtifact, built):
                report, art = jax_fleet_scan(env, "fs", [host0], ("secret",), **cfg)
    finally:
        release.set()
        th.join(timeout=WAIT)
        shutdown([h for h, _ in servers])
    st = art.stats()
    return results(report), {
        "joined": joined, "joins": st["joins"], "steals": st["steals"],
        "shares": [st["replica_shards"].get(h, 0) for h in (host0, joiner)],
        "scraped": sorted(ctx.fleet["replicas"]) == sorted([host0, joiner]),
        "weights": sorted(ctx.fleet["controller"]["final"]) == sorted([host0, joiner]),
        "joins_counted": ctx.counters.get("fleet.joins"),
    }, {"joiner": joiner}


def test_a_join_mid_sweep_steals_work(env):
    """One replica takes the sweep; a second registers once the first shard
    is dispatched and steals every other shard; the poller and the
    controller pick the joiner up. Results equal the single-host scan and
    the counters the JAX coordinator's on the same script."""
    n = len(port_fs_plan(env, 6))
    assert n >= 4
    mine_results, mine, _ = run_join(env, "port", n)
    ref_results, ref, _ = run_join(env, "jax", n)
    assert mine_results == results(port_single(env, "fs")) == ref_results
    for got in (mine, ref):
        assert [d["Known"] for d in got.pop("joined")] == [False]
    assert mine == ref
    assert mine == {"joins": 1, "steals": n - 1, "shares": [1, n - 1], "scraped": True,
                    "weights": True, "joins_counted": 1}


def test_deregister_is_idempotent_and_hands_the_queue_back():
    """White-box and over the wire: deregistering replica 0 moves its whole
    queue to replica 1 once; a repeat and an unknown host are answers, and
    a draining replica takes no fragment; equal to the JAX coordinator."""
    hosts = ["127.0.0.1:1", "127.0.0.1:2"]
    seen = []
    for coord, (state_cls, spec_cls) in zip(coordinators(hosts), PAIRS):
        queued = [shard(state_cls, spec_cls, i, 100 * (i + 1)) for i in range(3)]
        coord._queues, coord._shards = [list(queued), []], list(queued)
        answers = [coord.deregister_replica(h) for h in (hosts[0], hosts[0], "127.0.0.1:7")]
        extra = shard(state_cls, spec_cls, 9, 5)
        with coord._lock:
            coord._place_fragment_locked(extra, avoid=set())
        seen.append((answers, [[s.spec.index for s in q] for q in coord._queues],
                     coord.stats["drains"]))
    assert seen[0] == seen[1]
    assert seen[0][1] == [[], [2, 1, 0, 9]] and seen[0][2] == 1
    (front, front_host), (r0, host0) = replica("port"), replica("port")
    try:
        coord = coordinators([host0])[0]
        front.service.fleet_deregister_hook = coord.deregister_replica
        assert post_deregister(front_host, host0) == {"Host": host0, "Known": True,
                                                      "Draining": True, "Replicas": 1}
        assert post_deregister(front_host, host0)["Draining"] is True
        assert coord.stats["drains"] == 1
    finally:
        shutdown([front, r0])
