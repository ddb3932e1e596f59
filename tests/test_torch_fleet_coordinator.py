"""The port's fleet coordinator (``trivy_tpu_torch/fleet/coordinator.py``
and ``fleet/merge.py`` behind ``cli.scan_fleet``) held against the JAX
coordinator (``trivy_tpu/fleet/``).

- Config: ``FleetConfig.from_opts`` equals the JAX one on the same options
  and environment (hosts required, ``inflight`` through the tuning layer and
  ``TRIVY_TPU_FLEET_INFLIGHT``, an explicit 0 for speculation and split).
- Parity: an fs tree and a six-layer image with a whiteout, each scanned by
  the port coordinator over port replicas, by the port without a fleet, by
  the JAX coordinator over JAX replicas and by the port coordinator over
  JAX replicas, give equal ``Results``.
- Failure ladder: a dead replica (closed, or faulted at ``fleet.dispatch``)
  and one that dies mid-scan re-dispatch; a ``fleet.result`` fault
  re-dispatches one shard; every replica dead falls back to a local scan
  on the coordinator's device with root ``Degraded``, or raises
  ``FleetError`` with the host fallback off.
- Steal, speculation, split and drain run as scripts in which the slow
  replica waits on a ``threading.Event`` (never a sleep skew), and each
  script's counters equal the JAX coordinator's on the same script.
  White-box: a parent win supersedes its fragments, a children win
  resolves the parent, a ``fleet.split`` fault abandons the split, and the
  seeded median, each as the JAX coordinator settles the same state.
- Observability: the verdict's buckets sum to 100 per replica; the
  profile's ``fleet`` block, ``fleet_table_lines`` and the heartbeat's
  fleet fragment equal the JAX ones; replica traces join the coordinator's
  trace as pids of their own; progress never goes back.
- Warm seed: a port replica seeded from the JAX export and from the port
  export serves the same rows, and so does a JAX replica.

Servers run in-process on the CPU over the small tree and image of
``tests/test_torch_fleet_replica.py``; every test checks that no
``fleet-worker`` thread outlives its scan.
"""

import dataclasses
import threading
import time
from unittest import mock

import pytest

from tests.test_torch_fleet_replica import (  # noqa: F401
    ALL,
    clean_breaker_gauges,
    env,
    jax_option,
    jax_scan_options,
    results,
    shutdown,
)
from tests.test_torch_fleet_replica import fleet_scan as jax_fleet_scan
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import faults as jax_faults
from trivy_tpu import obs as jax_obs
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.fanal.analyzers import secret as jax_secret_analyzer
from trivy_tpu.fleet import plan as jax_plan
from trivy_tpu.fleet.coordinator import FleetConfig as JaxFleetConfig
from trivy_tpu.fleet.coordinator import FleetCoordinator as JaxFleetCoordinator
from trivy_tpu.fleet.coordinator import _ShardState as JaxShardState
from trivy_tpu.fleet.merge import FleetArtifact as JaxFleetArtifact
from trivy_tpu.obs import profile as jax_profile
from trivy_tpu.rpc.admission import resolve_admission as jax_resolve_admission
from trivy_tpu.rpc.server import start_server as jax_start_server
from trivy_tpu.scanner import ScanOptions as JaxScanOptions
from trivy_tpu.secret import hitstore as jax_hitstore
from trivy_tpu.tuning import resolve_tuning as jax_resolve_tuning
from trivy_tpu_torch import cli, faults, obs
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.fleet import FleetError, merge, plan
from trivy_tpu_torch.fleet.coordinator import FleetConfig, FleetCoordinator, _ShardState
from trivy_tpu_torch.obs import export
from trivy_tpu_torch.obs import profile
from trivy_tpu_torch.rpc.admission import resolve_admission
from trivy_tpu_torch.rpc.server import start_server
from trivy_tpu_torch.scanner import ScanOptions
from trivy_tpu_torch.secret import hitstore
from trivy_tpu_torch.tuning import resolve_tuning

WAIT = 60.0  # seconds a held replica waits at most
DEAD = ["127.0.0.1:9", "127.0.0.1:10"]  # nothing listens on either
# the counters a script's run must give equally in both packages
SCRIPT_STATS = ("shards", "dispatches", "steals", "speculative", "redispatches", "cancelled",
                "local_fallback", "splits", "drains")


def fleet_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name.startswith("fleet-worker")]


@pytest.fixture(autouse=True)
def no_fleet_threads_left():
    yield
    faults.clear()
    jax_faults.clear()
    assert not fleet_threads(), f"fleet threads outlived the scan: {fleet_threads()}"


# -- replicas and scans of both packages -----------------------------------------


def replica(pkg: str, slots: int = 2, before=None, after=None):
    """One in-process admission-enabled replica of ``pkg`` (``port`` or
    ``jax``) on the CPU; ``before(req)`` runs ahead of each of its scans (a
    hold), ``after(req)`` after one. Returns (httpd, host)."""
    if pkg == "port":
        httpd, port = start_server(cache=new_cache("memory"), device="cpu",
                                   admission=resolve_admission({"max_concurrent_scans": slots}))
    else:
        httpd, port = jax_start_server(
            cache=jax_new_cache("memory", None),
            admission=jax_resolve_admission({"max_concurrent_scans": slots}))
    if before is not None or after is not None:
        service = httpd.service
        orig = service.scan

        def scan(req, **kw):
            if before is not None:
                before(req)
            resp = orig(req, **kw)
            if after is not None:
                after(req)
            return resp

        service.scan = scan
    return httpd, f"127.0.0.1:{port}"


def recording(cls, built: list):
    """Patch ``cls.inspect`` (either package's ``FleetArtifact``) to append
    the artifact to ``built`` before it fans out."""
    orig = cls.inspect

    def inspect(self):
        built.append(self)
        return orig(self)

    return mock.patch.object(cls, "inspect", inspect)


def port_single(env, kind: str, scanners=("secret",)):
    """The port's scan without a fleet."""
    db = VulnDB.load(env["db"]) if "vuln" in scanners else None
    if kind == "fs":
        report, _ = cli.scan_fs(str(env["tree"]), config_path=env["cfg"], device="cpu",
                                scanners=scanners, license_full=True, db=db)
    else:
        report, _ = cli.scan_image(env["image"], config_path=env["cfg"], device="cpu",
                                   scanners=scanners, license_full=True, db=db,
                                   cache=new_cache("memory"))
    return report


def port_fleet_scan(env, kind: str, hosts, scanners=("secret",), built=None, **cfg_kw):
    """The port coordinator's scan over ``hosts``: (report, counters,
    artifact); ``built`` collects the artifact before it inspects, for a
    test that watches the fan-out from another thread. Speculation, the
    telemetry plane and the mid-scan split are off unless asked for."""
    cfg_kw.setdefault("speculate", 0.0)
    cfg_kw.setdefault("telemetry_interval", 0.0)
    cfg_kw.setdefault("split_threshold", 0.0)
    cfg = FleetConfig(hosts=list(hosts), **cfg_kw)
    built = [] if built is None else built
    db = VulnDB.load(env["db"]) if "vuln" in scanners else None
    target = str(env["tree"]) if kind == "fs" else env["image"]
    with recording(merge.FleetArtifact, built):
        report, counters = cli.scan_fleet(kind, target, cfg, device="cpu",
                                          config_path=env["cfg"], scanners=scanners,
                                          license_full=True, db=db)
    return report, counters, built[0]


def jax_fs_plan(env, n: int, scanners=("secret",)):
    shards, _, _ = jax_plan.plan_fs_shards(str(env["tree"]), jax_option(env, scanners),
                                           jax_scan_options(scanners), n)
    return shards


def port_fs_plan(env, n: int, scanners=("secret",)):
    shards, _, _ = plan.plan_fs_shards(str(env["tree"]), plan.ShardSettings(
        scanners=list(scanners), license_full=True, device="cpu", secret_config=env["cfg"]), n)
    return shards


# -- config ------------------------------------------------------------------------


@pytest.mark.parametrize("opts,environ", [
    ({"fleet": ["a:1", "b:2", "a:1"]}, {}),
    ({"fleet": "a:1, b:2", "fleet_inflight": 3, "fleet_speculate": 0.0,
      "fleet_split_threshold": 0.0, "fleet_telemetry_interval": 0.0, "token": "T",
      "no_host_fallback": True, "fleet_shards_per_replica": 2}, {}),
    ({"fleet": "a:1"}, {"TRIVY_TPU_FLEET_INFLIGHT": "5",
                        "TRIVY_TPU_FLEET_SPLIT_THRESHOLD": "0",
                        "TRIVY_TPU_FLEET_TELEMETRY_INTERVAL": "0"}),
    ({"fleet": "a:1", "fleet_inflight": 0, "fleet_speculate": 1.5,
      "fleet_register_token": "R"}, {"TRIVY_TPU_FLEET_INFLIGHT": "4"}),
], ids=["defaults", "every-flag", "environment", "cli-zero-falls-to-env"])
def test_config_from_opts_equals_jax(monkeypatch, opts, environ):
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    tuning = resolve_tuning(opts=opts, device="cpu")
    jtuning = jax_resolve_tuning(opts=opts)
    assert tuning.fleet_inflight == jtuning.fleet_inflight
    mine = FleetConfig.from_opts(opts, tuning=tuning)
    ref = JaxFleetConfig.from_opts(opts, tuning=jtuning)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.target_shards() == ref.target_shards()


def test_config_needs_a_replica():
    for opts in ({}, {"fleet": " , "}):
        with pytest.raises(ValueError, match="at least one replica"):
            FleetConfig.from_opts(opts)
        with pytest.raises(ValueError, match="at least one replica"):
            JaxFleetConfig.from_opts(opts)


def test_coordinator_refuses_the_telemetry_plane(env):
    """The coordinator takes the telemetry plane: with the JAX default
    interval (1.0) and a register token it builds, and its ``run`` builds
    the poller and the placement controller the poller ticks, sets the
    context's fleet doc and ``--live`` fragment, and retires both."""
    from trivy_tpu_torch.fleet.controller import FleetController
    from trivy_tpu_torch.fleet.telemetry import ReplicaPoller

    httpd, host = replica("port")
    try:
        coord = FleetCoordinator(FleetConfig(hosts=[host], register_token="R", speculate=0.0),
                                 ScanOptions(scanners=["secret"]))
        assert coord.cfg.telemetry_interval == 1.0 and coord.cfg.register_token == "R"
        assert coord.controller is None and coord._poller is None
        shards = port_fs_plan(env, 2)
        with obs.scan_context(name="plane", enabled=True) as ctx:
            blobs = coord.run(shards)
    finally:
        shutdown([httpd])
    assert sorted(blobs) == sorted(s.index for s in shards)
    assert isinstance(coord.controller, FleetController)
    assert isinstance(coord._poller, ReplicaPoller) and coord._poller.controller is coord.controller
    assert ctx.fleet["interval_s"] == 1.0 and list(ctx.fleet["replicas"]) == [host]
    assert ctx.fleet["replicas"][host]["scrapes"] >= 2  # the baseline and the final tick
    assert ctx.fleet_live == coord._poller.live_fragment
    assert not [t for t in threading.enumerate() if t.name.startswith("fleet-telemetry")]


# -- parity ------------------------------------------------------------------------


@pytest.mark.parametrize("kind,scanners", [
    ("fs", ("secret",)), ("fs", ALL), ("image", ALL),
], ids=["fs-secret", "fs-all", "image-all"])
def test_four_scans_give_equal_results(env, kind, scanners):
    """Port over port, port alone, JAX over JAX, port over JAX."""
    servers = [replica("port"), replica("port"), replica("jax"), replica("jax")]
    port_hosts = [h for _, h in servers[:2]]
    jax_hosts = [h for _, h in servers[2:]]
    try:
        mine, counters, art = port_fleet_scan(env, kind, port_hosts, scanners)
        alone = port_single(env, kind, scanners)
        ref, _ = jax_fleet_scan(env, kind, jax_hosts, scanners)
        mixed, _, _ = port_fleet_scan(env, kind, jax_hosts, scanners)
    finally:
        shutdown([h for h, _ in servers])
    want = results(alone)
    assert want, "parity against an empty report proves nothing"
    assert results(mine) == want == results(ref) == results(mixed)
    assert not (mine.degraded or mixed.degraded)
    stats = art.stats()
    assert counters["fleet.shards"] == stats["shards"] >= (6 if kind == "image" else 4)
    assert all(stats["replica_shards"][h] > 0 for h in port_hosts), stats["replica_shards"]
    if kind == "image":
        assert mine.metadata == alone.metadata == ref.metadata
        assert not any("app0/cred.txt" in r.target for r in mine.results)  # the whiteout
    else:
        assert mine.artifact_name == alone.artifact_name


def test_replica_without_job_api_takes_sync_shards(env):
    httpd, port = start_server(cache=new_cache("memory"), device="cpu")
    try:
        report, counters, art = port_fleet_scan(env, "fs", [f"127.0.0.1:{port}"])
    finally:
        httpd.shutdown()
    assert art.coordinator._sync_only == [True]
    assert results(report) == results(port_single(env, "fs"))
    assert counters["fleet.dispatches"] == counters["fleet.shards"]


# -- failure ladder ----------------------------------------------------------------


@pytest.mark.parametrize("how", ["closed", "fault"])
def test_dead_replica_redispatches(env, how):
    """Replica 0 dead from the first dispatch (its socket closed, or every
    ``fleet.dispatch`` to it faulted): every shard lands on replica 1."""
    servers = [replica("port"), replica("port")]
    hosts = [h for _, h in servers]
    if how == "closed":
        servers[0][0].shutdown()
        servers[0][0].server_close()
    else:
        faults.configure(f"fleet.dispatch@{hosts[0]}:times=-1")
    try:
        report, counters, _ = port_fleet_scan(env, "fs", hosts)
    finally:
        shutdown([h for h, _ in (servers[1:] if how == "closed" else servers)])
    assert results(report) == results(port_single(env, "fs"))
    assert not report.degraded
    assert counters["fleet.redispatches"] >= 1
    assert counters["fleet.replica_shards"] == {hosts[0]: 0, hosts[1]: counters["fleet.shards"]}


def test_replica_dying_mid_scan_redispatches(env):
    calls = []

    def die(req):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("replica killed mid-scan")

    servers = [replica("port", before=die), replica("port")]
    try:
        report, counters, _ = port_fleet_scan(env, "fs", [h for _, h in servers])
    finally:
        shutdown([h for h, _ in servers])
    assert results(report) == results(port_single(env, "fs"))
    assert not report.degraded
    assert counters["fleet.redispatches"] >= 1 and counters["fleet.local_fallback"] == 0


def test_result_fault_redispatches_one_shard(env):
    servers = [replica("port"), replica("port")]
    faults.configure("fleet.result:at=1")
    try:
        report, counters, _ = port_fleet_scan(env, "fs", [h for _, h in servers])
    finally:
        shutdown([h for h, _ in servers])
    assert results(report) == results(port_single(env, "fs"))
    assert counters["fleet.redispatches"] == 1 and not report.degraded


def test_all_dead_falls_back_to_a_local_scan(env):
    report, counters, art = port_fleet_scan(env, "fs", DEAD, rpc_retries=0, rpc_deadline=2.0)
    assert results(report) == results(port_single(env, "fs"))
    assert report.degraded and report.to_dict()["Degraded"] is True
    assert counters["fleet.local_fallback"] == counters["fleet.shards"] > 0
    assert art.coordinator.breaker.open_devices() == [0, 1]
    assert all(row["dead"] == 100.0 for row in art.coordinator.verdict.values())


def test_all_dead_without_host_fallback_raises(env):
    with pytest.raises(FleetError, match="no-host-fallback"):
        port_fleet_scan(env, "fs", DEAD[:1], host_fallback=False, rpc_retries=0,
                        rpc_deadline=2.0)


# -- steal, speculation, split, drain: scripts run on both packages ---------------


def run_script(env, pkg: str, script, **cfg_kw) -> tuple[list, dict]:
    """``script(hosts, built)`` sets up two replicas of ``pkg`` (returning
    the servers and a release callable) before the scan; the scan is that
    package's coordinator. Returns (Results, stats by replica index)."""
    built: list = []
    servers, release = script(pkg, built)
    hosts = [h for _, h in servers]
    try:
        if pkg == "port":
            report, _, art = port_fleet_scan(env, "fs", hosts, built=built, **cfg_kw)
        else:
            with recording(JaxFleetArtifact, built):
                report, art = jax_fleet_scan(env, "fs", hosts, ("secret",), **cfg_kw)
    finally:
        release()
        shutdown([h for h, _ in servers])
    stats = art.stats()
    shares = [stats["replica_shards"][h] for h in hosts]
    return results(report), {**{k: stats[k] for k in SCRIPT_STATS}, "shares": shares}


def both(env, script, **cfg_kw) -> dict:
    """The script's stats, equal in both packages, with the single-host
    Results from each."""
    port_results, mine = run_script(env, "port", script, **cfg_kw)
    jax_results, ref = run_script(env, "jax", script, **cfg_kw)
    assert port_results == results(port_single(env, "fs")) == jax_results
    assert mine == ref
    return mine


def steal_script(pkg, built):
    """Replica 0 holds its first shard until replica 1 has run seven:
    its own four and three stolen from replica 0's queue."""
    release = threading.Event()
    done = []

    def count(req):
        done.append(1)
        if len(done) >= 7:
            release.set()

    servers = [replica(pkg, before=lambda req: release.wait(WAIT)), replica(pkg, after=count)]
    return servers, release.set


def test_work_steal_on_a_held_replica(env):
    stats = both(env, steal_script, inflight=1, shards_per_replica=4, split_threshold=0.0)
    assert stats["steals"] == 3 and stats["shares"] == [1, 7], stats


def test_steal_fault_requeues_the_shard(env):
    """The first steal faults at ``fleet.steal``: the shard goes back to the
    stealer's own queue and is run, never lost."""

    def script(pkg, built):
        servers, release = steal_script(pkg, built)
        (faults if pkg == "port" else jax_faults).configure(
            f"fleet.steal@{servers[1][1]}:at=1")
        return servers, release

    stats = both(env, script, inflight=1, shards_per_replica=4, split_threshold=0.0)
    assert stats["steals"] == 3 and stats["shares"] == [1, 7], stats


def test_speculation_first_result_wins(env):
    """Replica 0 holds its one shard: replica 1 runs its own, then the
    straggler's speculative twin, which wins; replica 0's attempt is
    cancelled."""

    def script(pkg, built):
        release = threading.Event()
        return [replica(pkg, before=lambda req: release.wait(WAIT)), replica(pkg)], release.set

    stats = both(env, script, inflight=1, shards_per_replica=1, speculate=1.0,
                 speculate_floor_s=0.3, split_threshold=0.0)
    assert stats["speculative"] == 1 and stats["cancelled"] == 1, stats
    assert stats["shares"] == [0, 2], stats


def test_straggler_split_children_win(env):
    """Shard 0 (the largest, several units) is held wherever it runs: replica
    1 runs its two shards, steals shard 2, splits the straggler and runs both
    fragments (the second stolen back from replica 0's queue); the fragments
    resolve the parent and its attempt is cancelled."""
    (parent,) = port_fs_plan(env, 4)[:1]
    assert plan.split_fs_shard(parent) is not None
    assert parent.wire["Paths"] == jax_fs_plan(env, 4)[0].wire["Paths"]

    def script(pkg, built):
        release = threading.Event()

        def hold(req):
            if (req.get("Shard") or {}).get("Paths") == parent.wire["Paths"]:
                release.wait(WAIT)

        return [replica(pkg, before=hold), replica(pkg, before=hold)], release.set

    stats = both(env, script, inflight=1, shards_per_replica=2, split_threshold=1.5,
                 speculate_floor_s=0.2)
    assert stats["splits"] == 1 and stats["steals"] == 2 and stats["cancelled"] == 1, stats
    assert stats["shares"] == [0, 5], stats


def test_drain_hands_queued_shards_back(env):
    """Replica 0 (one scan slot) runs one shard, held, with its second
    queued, while replica 1 runs two, held; replica 0 starts draining and
    rejects its queued job: the coordinator hands it and replica 0's queue
    to replica 1 with no breaker penalty."""

    def script(pkg, built):
        release = threading.Event()
        servers = [replica(pkg, slots=slots, before=lambda req: release.wait(WAIT))
                   for slots in (1, 2)]
        adm = [h.service.admission for h, _ in servers]

        def drain():
            deadline = time.monotonic() + WAIT
            # replica 0's first job started (held) and its second queued
            while not (adm[0].running() >= 1 and adm[0].queue_depth() >= 1
                       and adm[1].running() >= 2):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            servers[0][0].service.draining = True
            servers[0][0].service.admission.reject_queued()
            while not (built and built[0].coordinator is not None
                       and built[0].coordinator.stats["drains"] == 1):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            release.set()

        threading.Thread(target=drain, daemon=True, name="drain-script").start()
        return servers, release.set

    stats = both(env, script, inflight=2, shards_per_replica=4, split_threshold=0.0)
    assert stats["drains"] == 1 and stats["redispatches"] == 0 and stats["steals"] == 0, stats
    assert stats["shares"] == [1, 7], stats


# -- white-box: the split race and the seeded median, in both packages ------------


def coordinators(hosts, **cfg_kw):
    cfg_kw.setdefault("telemetry_interval", 0.0)
    return (FleetCoordinator(FleetConfig(hosts=list(hosts), **cfg_kw),
                             ScanOptions(scanners=["secret"])),
            JaxFleetCoordinator(JaxFleetConfig(hosts=list(hosts), **cfg_kw),
                                JaxScanOptions(scanners=["secret"])))


def straggler_states(coord, state_cls, shards, ages=(10.0, 1.0)):
    """Every shard in flight on replica 0, started ``ages`` seconds ago and
    fully counted (walked, not finished)."""
    coord._queues = [[], []]
    coord._run_started = time.monotonic() - 10.0
    states = [state_cls(s) for s in shards]
    for s, age in zip(states, ages):
        s.state = "inflight"
        s.running = {0}
        s.started = time.monotonic() - age
        s.counted = s.spec.nbytes
    coord._shards = states
    return states


def test_take_splits_a_straggler_as_jax(env):
    """An idle worker with nothing queued or stealable and a stalled fs
    shard gets the largest fragment of a fresh split; the rest are queued,
    and no path is lost or doubled (the seeded median: nothing completed)."""
    outcomes = []
    for coord, state_cls, shards in zip(
            coordinators(DEAD, split_threshold=1.5, speculate_floor_s=0.05, speculate=0.0),
            (_ShardState, JaxShardState), (port_fs_plan(env, 2), jax_fs_plan(env, 2))):
        straggler, _ = straggler_states(coord, state_cls, shards)
        with coord._cond:
            got, how = coord._take_locked(1)
        assert how == "split" and got.parent is straggler and straggler.split
        union = sorted(p for c in straggler.children for p in c.spec.wire["Paths"])
        assert union == sorted(straggler.spec.wire["Paths"])
        queued = [s.spec.wire["Paths"] for q in coord._queues for s in q]
        outcomes.append((how, got.spec.wire["Paths"], queued, coord.stats["splits"]))
    assert outcomes[0] == outcomes[1]


def test_split_fault_abandons_the_split(env):
    for coord, state_cls, shards, fmod in zip(
            coordinators(DEAD, split_threshold=0.5, speculate_floor_s=0.05, speculate=0.0),
            (_ShardState, JaxShardState), (port_fs_plan(env, 2), jax_fs_plan(env, 2)),
            (faults, jax_faults)):
        (s,) = straggler_states(coord, state_cls, shards[:1])
        fmod.configure(f"fleet.split@{s.spec.index}:at=1:times=1")
        with coord._cond:
            assert coord._take_locked(1) == (None, "")
        assert s.children is None and s.split and coord.stats["splits"] == 0
        fmod.clear()


def race(coord, state_cls, spec_cls):
    coord._queues = [[], []]
    parent = state_cls(spec_cls(index=0, kind="fs", nbytes=100, wire={"Kind": "fs"}))
    kids = [state_cls(spec_cls(index=0.25 * (k + 1), kind="fs", nbytes=nb, wire={"Kind": "fs"}))
            for k, nb in enumerate((60, 40))]
    for c in kids:
        c.parent = parent
    parent.children = kids
    coord._shards = [parent, *kids]
    return parent, kids


@pytest.mark.parametrize("winner", ["parent", "children"])
def test_split_race_settles_as_jax(winner):
    seen = []
    for coord, state_cls, spec_cls in zip(coordinators(DEAD), (_ShardState, JaxShardState),
                                          (plan.ShardSpec, jax_plan.ShardSpec)):
        parent, kids = race(coord, state_cls, spec_cls)
        kids[0].done, kids[0].state, kids[0].blobs = True, "done", [{"BlobID": "x"}]
        if winner == "parent":
            coord._queues[1].append(kids[1])
            parent.done, parent.state = True, "done"
            with coord._lock:
                coord._resolve_split_locked(parent)
            assert kids[0].blobs is None and kids[1] not in coord._queues[1]
        else:
            with coord._lock:
                coord._resolve_split_locked(kids[0])
            assert not parent.done
            kids[1].done, kids[1].state = True, "done"
            with coord._lock:
                coord._resolve_split_locked(kids[1])
            assert coord._pending_locked() == 0
        seen.append([(s.done, s.state, s.resolved_by) for s in (parent, *kids)])
    assert seen[0] == seen[1]


def test_seeded_median_as_jax():
    for coord, state_cls, spec_cls in zip(coordinators(DEAD), (_ShardState, JaxShardState),
                                          (plan.ShardSpec, jax_plan.ShardSpec)):
        coord._durations = [2.0, 4.0, 6.0]
        with coord._lock:
            assert coord._median_wall_locked() == 4.0
        coord._durations = []
        coord._run_started = time.monotonic() - 1.0
        a, b = (state_cls(spec_cls(index=i, kind="fs", nbytes=1000, wire={"Kind": "fs"}))
                for i in range(2))
        coord._shards = [a, b]
        with coord._lock:
            assert coord._median_wall_locked() is None  # no progress yet
        b.counted = 500  # half a shard in ~1 s: a median shard takes ~2 s
        with coord._lock:
            assert 1.5 < coord._median_wall_locked() < 3.0
        b.parent = a  # a fragment never seeds the median
        with coord._lock:
            assert coord._median_wall_locked() is None


# -- observability -----------------------------------------------------------------


def test_trace_join_progress_and_verdict(env):
    """Under a traced context: one trace id over every joined shard doc,
    replicas as pids of their own, progress covering the plan and never
    going back, the verdict's buckets summing to 100 and the profile's
    fleet rows one per shard."""
    servers = [replica("port"), replica("port")]
    hosts = [h for _, h in servers]
    ratios: list = []
    stop = threading.Event()
    try:
        with obs.scan_context(name="fleet-test", enabled=True) as ctx:
            def sample():
                while not stop.wait(0.01):
                    prog = ctx.progress_peek()
                    if prog is not None:
                        ratios.append(prog.ratio())

            t = threading.Thread(target=sample, daemon=True)
            t.start()
            report, counters, art = port_fleet_scan(env, "fs", hosts)
            stop.set()
            t.join(timeout=5)
            snap = ctx.progress().snapshot()
            events = export.chrome_trace_events(ctx)
            doc = ctx.profile_doc()
    finally:
        stop.set()
        shutdown([h for h, _ in servers])
    assert report.results
    assert ctx.remote and {d.get("trace_id") for d in ctx.remote} == {ctx.trace_id}
    pids = {e["pid"] for e in events}
    assert 1 in pids and len(pids - {1}) >= len(hosts)
    assert ratios and all(b >= a for a, b in zip(ratios, ratios[1:]))
    assert snap["bytes_scanned"] == snap["bytes_walked"] > 0 and snap["walk_complete"]
    verdict = art.coordinator.verdict
    assert set(verdict) == set(hosts)
    for row in verdict.values():
        assert round(sum(row[k] for k in ("busy", "idle", "stalled_on_coordinator",
                                          "dead")), 1) == 100.0
    assert doc["fleet"]["replicas"] == verdict
    assert len(doc["fleet"]["shards"]) == counters["fleet.shards"]
    assert profile.fleet_table_lines(doc) == jax_profile.fleet_table_lines(doc)


def test_profile_fleet_block_and_table_equal_jax():
    verdict = {"10.0.0.1:4954": {"shards": 3, "busy_s": 1.5, "busy": 61.2, "idle": 30.1,
                                 "stalled_on_coordinator": 8.7, "dead": 0.0},
               "10.0.0.2:4954": {"shards": 0, "busy_s": 0.0, "busy": 0.0, "idle": 0.0,
                                 "stalled_on_coordinator": 0.0, "dead": 100.0}}
    docs = []
    for mod in (profile, jax_profile):
        p = mod.ScanProfile()
        p.note_shard("10.0.0.1:4954", 3 << 20, 0.8, stolen=True, attempts=2)
        p.note_shard("10.0.0.1:4954", 1 << 20, 0.2, speculated=True)
        p.note_shard("local", 5 << 20, 1.25, attempts=4)
        p.note_fleet(verdict)
        merged = mod.ScanProfile()
        merged.merge_dict(p.to_dict())
        merged.merge_dict({"fleet": {"shards": [{"replica": "10.0.0.1:4954", "bytes": 7}]}})
        doc = merged.to_dict()
        docs.append((p.to_dict(), doc, mod.fleet_table_lines(doc)))
    assert docs[0] == docs[1]
    assert len(docs[0][2]) == 3 and "100.0" in docs[0][2][2]
    assert profile.fleet_table_lines({"rules": {}}) == []


def test_report_prints_the_fleet_table(capsys):
    ctx = obs.TraceContext(enabled=True)
    ctx.profile().note_fleet({"h:1": {"busy": 100.0, "idle": 0.0,
                                      "stalled_on_coordinator": 0.0, "dead": 0.0}})
    ctx.report()
    err = capsys.readouterr().err
    assert "-- fleet efficiency" in err and "h:1" in err


@pytest.mark.parametrize("status", [
    {"replicas": 3, "healthy": 2, "breaker_open": 1, "fleet_mbs": None, "shards_done": 5,
     "shards_total": 12},
    {"replicas": 2, "healthy": 2, "breaker_open": 0, "fleet_mbs": 12.25, "shards_done": 0,
     "shards_total": 8},
])
def test_heartbeat_fleet_fragment_equals_jax(monkeypatch, status):
    """The beat's text with a fleet status, the device fragment aside."""
    from trivy_tpu.obs import recorder as jax_recorder
    from trivy_tpu_torch.obs import recorder

    texts = []
    for mod, rec in ((obs, recorder), (jax_obs, jax_recorder)):
        monkeypatch.setattr(rec, "heartbeat_fragment", lambda carrier: "")
        ctx = mod.TraceContext()
        ctx.progress().note_walked(100)
        ctx.fleet_status = lambda: dict(status)
        beat = mod.heartbeat(None, "x")
        beat._ctx = ctx
        texts.append(beat._telemetry())
    assert texts[0] == texts[1]
    assert f"fleet {status['shards_done']}/{status['shards_total']} shards, " in texts[0]


def test_heartbeat_reads_the_coordinator_status(env):
    """After a fan-out the context's status callable reports the shards
    done and the replicas healthy from the coordinator's breakers."""
    with obs.scan_context(name="hb") as ctx:
        report, counters, art = port_fleet_scan(env, "fs", DEAD[:1], rpc_retries=0,
                                                rpc_deadline=2.0)
        st = ctx.fleet_status()
    assert st == {"replicas": 1, "healthy": 0, "breaker_open": 1, "fleet_mbs": None,
                  "shards_done": counters["fleet.shards"],
                  "shards_total": counters["fleet.shards"]}


# -- warm seed across packages -----------------------------------------------------


def seeded_replica_stats(env, pkg: str, seed: list) -> tuple[dict, object]:
    """One replica of ``pkg`` on its device path, seeded with ``seed`` on
    its only shard by the JAX coordinator (``Backend: auto``): the feed
    counters of the secret scanner it built, and that scanner."""
    scanners = []
    if pkg == "port":
        class Recording(plan.ScanAnalyzers):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                scanners.append(self.scanner)

        patch = mock.patch.object(plan, "ScanAnalyzers", Recording)
    else:
        patch = mock.patch.dict(jax_secret_analyzer._scanner_cache, {}, clear=True)
    httpd, host = replica(pkg)
    try:
        with patch:
            report, art = jax_fleet_scan(env, "fs", [host], ("secret",), backend="auto",
                                         shards_per_replica=1, warm_seed=seed)
            if pkg == "jax":
                scanners = [v[0] for v in jax_secret_analyzer._scanner_cache.values()]
    finally:
        httpd.shutdown()
    assert art.stats()["warm_seeded"] == (1 if seed else 0)
    assert results(report) == results(port_single(env, "fs"))
    (sc,) = scanners
    st = sc.stats.snapshot()
    return {k: st[k] for k in ("chunks_uploaded", "chunks_dedup_hit", "chunks_warm_hit")}, sc


def coordinator_export(pkg: str, scanner) -> list:
    """What ``pkg``'s coordinator exports from a scan cache holding the
    warm entries ``scanner`` computed: its ``export_backend_warm``."""
    if pkg == "port":
        cache = new_cache("memory")
        cache.set_blobs(dict(scanner.export_warm_hits()))
        return hitstore.export_backend_warm(cache)
    cache = jax_new_cache("memory", None)
    for k, v in scanner.export_warm_hits():
        cache.put_blob(k, v)
    return jax_hitstore.export_backend_warm(cache)


def test_warm_seed_across_packages(env):
    """Each package's replica takes the other's export: the entries are the
    same JSON (either ``export_backend_warm`` reads the other's cache), and
    a replica keeps the ones of its own namespace. Seeded from its own
    package's export a replica serves every row; the other package's rows
    are of another length (the port's 16,384 bytes against the JAX XLA
    path's 65,536), so those entries are dropped with a warning and the
    counters equal a cold replica's."""
    cold, scanners = {}, {}
    for pkg in ("port", "jax"):
        cold[pkg], scanners[pkg] = seeded_replica_stats(env, pkg, [])
    exports = {pkg: coordinator_export(pkg, sc) for pkg, sc in scanners.items()}
    assert exports["port"] and exports["jax"]
    cache = new_cache("memory")
    cache.set_blobs(dict(exports["jax"]))
    assert hitstore.export_backend_warm(cache) == exports["jax"]
    jcache = jax_new_cache("memory", None)
    for k, v in exports["port"]:
        jcache.put_blob(k, v)
    assert jax_hitstore.export_backend_warm(jcache) == exports["port"]
    for pkg, other in (("port", "jax"), ("jax", "port")):
        served, _ = seeded_replica_stats(env, pkg, exports[pkg])
        dropped, _ = seeded_replica_stats(env, pkg, exports[other])
        assert served["chunks_uploaded"] == 0 and served["chunks_dedup_hit"] > 0, (pkg, served)
        assert cold[pkg]["chunks_uploaded"] > 0
        assert dropped == cold[pkg], (pkg, dropped, cold[pkg])
        assert served["chunks_warm_hit"] == dropped["chunks_warm_hit"]
