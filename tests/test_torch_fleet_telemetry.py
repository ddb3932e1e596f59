"""The port's fleet telemetry plane (``trivy_tpu_torch/fleet/telemetry.py``
and the ``fleet`` blocks of ``obs/export.py``, the ``--live`` line and the
heartbeat) held against the JAX package's (``trivy_tpu/fleet/telemetry.py``).

- ``ReplicaHealth``: the same seeded ``/metrics`` texts (some gauges
  absent, arena 0 in some) fold into equal ``last`` values, headroom and
  ``to_doc()`` in both packages; a property over busy, queue and arena.
- ``ReplicaPoller``: its thread's name and lifecycle, gauge rows that stop
  retires, disjoint rows for two fleets, and each package's poller
  scraping the other package's server.
- A two-replica fleet scan with the poller at 0.05 s: ``Results`` equal to
  the JAX coordinator's, and the metrics and time-series ``fleet`` blocks,
  the Perfetto counter tracks, the ``--live`` fragment and the heartbeat
  fragment with the JAX keys and formats.
- At interval 0 ``FleetCoordinator.run`` builds no poller or controller,
  the exports have no ``fleet`` block, and neither module is imported.

Servers run in-process on the CPU; every test checks that no
``fleet-telemetry`` or ``fleet-worker`` thread and no
``trivy_tpu_fleet_*`` gauge row outlives it.
"""

import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_fleet_coordinator import port_fleet_scan, port_fs_plan, replica
from tests.test_torch_fleet_replica import RESTRICTED, env, results, shutdown  # noqa: F401
from tests.test_torch_fleet_replica import fleet_scan as jax_fleet_scan
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import obs as jax_obs
from trivy_tpu.fleet import telemetry as jax_telemetry
from trivy_tpu.fleet.coordinator import FleetConfig as JaxFleetConfig
from trivy_tpu.fleet.coordinator import FleetCoordinator as JaxFleetCoordinator
from trivy_tpu.obs import export as jax_export
from trivy_tpu.obs import metrics as jax_metrics
from trivy_tpu.parallel import mesh as jax_mesh
from trivy_tpu.scanner import ScanOptions as JaxScanOptions
from trivy_tpu_torch import obs
from trivy_tpu_torch.fleet import telemetry
from trivy_tpu_torch.fleet.coordinator import FleetConfig, FleetCoordinator
from trivy_tpu_torch.obs import export
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs.timeseries import LiveProgress
from trivy_tpu_torch.parallel import mesh
from trivy_tpu_torch.scanner import ScanOptions

REPO = Path(__file__).resolve().parents[1]
DEAD = "127.0.0.1:9"  # nothing listens there
# a --live fleet fragment: each replica's busy %, MB/s and queue, or OPEN
LIVE = re.compile(r"^fleet\[r0 (\d+% \d+MB/s q\d+|OPEN)( \| r\d+ (\d+% \d+MB/s q\d+|OPEN))*\]$")


def plane_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("fleet-telemetry", "fleet-worker"))]


def fleet_rows(registry) -> list[str]:
    return [line for line in registry.render().splitlines()
            if line.startswith("trivy_tpu_fleet_")]


@pytest.fixture(autouse=True)
def nothing_outlives_the_test():
    """No plane thread or fleet gauge row survives a test, and the breaker
    gauges (process-global; a server sheds while every row reads open) are
    put back as they were."""
    gauges = [jax_mesh._BREAKER_OPEN, mesh._BREAKER_OPEN]
    saved = [dict(g._values) for g in gauges]
    yield
    for g, rows in zip(gauges, saved):
        with g._lock:
            g._values.clear()
            g._values.update(rows)
    assert not plane_threads(), plane_threads()
    assert not fleet_rows(obs_metrics.REGISTRY) and not fleet_rows(jax_metrics.REGISTRY)


# -- ReplicaHealth on the same /metrics texts --------------------------------------


def metrics_text(rng) -> str:
    """One replica's ``/metrics`` body with the families the scrape folds,
    each present or not, at seeded values (arena sometimes 0)."""
    lines = []

    def gauge(name, samples):
        lines.append(f"# TYPE {name} gauge")
        for labels, v in samples:
            lab = ",".join(f'{k}="{val}"' for k, val in labels.items())
            lines.append(f"{name}{{{lab}}} {v}" if lab else f"{name} {v}")

    if rng.random() < 0.8:
        gauge("trivy_tpu_link_mbs", [({}, round(float(rng.uniform(0, 4000)), 3))])
    if rng.random() < 0.8:
        gauge("trivy_tpu_arena_free_slabs", [({}, int(rng.integers(0, 3)))])
    if rng.random() < 0.8:
        gauge("trivy_tpu_device_busy_ratio",
              [({"device": f"cuda:{d}"}, round(float(rng.uniform(0, 1)), 4))
               for d in range(int(rng.integers(1, 3)))])
    if rng.random() < 0.7:
        gauge("trivy_tpu_admission_queue_depth",
              [({"tenant": t}, int(rng.integers(0, 4))) for t in ("a", "b")[:rng.integers(1, 3)]])
    if rng.random() < 0.6:
        gauge("trivy_tpu_device_breaker_open",
              [({"device": "d0"}, int(rng.integers(0, 2)))])
    if rng.random() < 0.6:
        gauge("trivy_tpu_requests_in_flight", [({}, int(rng.integers(0, 3)))])
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_replica_health_equals_jax(seed):
    """A run of scrapes, failures and progress notes, at equal timestamps:
    ``last``, the headroom and the whole ``to_doc()`` equal at every step."""
    rng = np.random.default_rng(seed)
    mine, ref = telemetry.ReplicaHealth("h:1"), jax_telemetry.ReplicaHealth("h:1")
    assert mine.headroom() == ref.headroom() == 0.0  # never scraped: unreachable
    for k in range(8):
        t = 0.25 * k
        event = rng.random()
        if event < 0.15:
            mine.note_failure(t)
            ref.note_failure(t)
        else:
            text = metrics_text(rng)
            mine.note_scrape(t, obs_metrics.parse_text(text))
            ref.note_scrape(t, jax_metrics.parse_text(text))
            if event > 0.8:
                ratio, jobs = round(float(rng.uniform(0, 1)), 4), int(rng.integers(1, 3))
                mine.note_progress(t, ratio, jobs)
                ref.note_progress(t, ratio, jobs)
        if rng.random() < 0.2:
            mine.breaker_open = ref.breaker_open = not mine.breaker_open
        assert mine.last == ref.last
        assert mine.headroom() == ref.headroom()
        assert 0.0 <= mine.headroom() <= 1.0
        assert mine.to_doc() == ref.to_doc()


@settings(max_examples=200, deadline=None)
@given(busy=st.floats(-0.5, 1.5), queue=st.floats(0, 50), arena=st.sampled_from([None, 0, 1, 7]),
       reachable=st.booleans(), breaker=st.booleans())
def test_headroom_property_equals_jax(busy, queue, arena, reachable, breaker):
    last = {"device_busy_ratio": busy, "queue_depth": queue}
    if arena is not None:
        last["arena_free_slabs"] = float(arena)
    got = []
    for mod in (telemetry, jax_telemetry):
        rh = mod.ReplicaHealth("h:1")
        rh.reachable, rh.breaker_open, rh.last = reachable, breaker, dict(last)
        got.append(rh.headroom())
    assert got[0] == got[1]
    assert 0.0 <= got[0] <= 1.0
    if not reachable or breaker:
        assert got[0] == 0.0
    else:
        want = (1 - min(1.0, max(0.0, busy))) / (1 + queue) * (0.5 if arena == 0 else 1.0)
        assert got[0] == round(want, 4)


# -- the poller --------------------------------------------------------------------


def port_coordinator(hosts, **kw):
    return FleetCoordinator(FleetConfig(hosts=list(hosts), rpc_retries=0, rpc_deadline=1.0, **kw),
                            ScanOptions(scanners=["secret"]))


def jax_coordinator(hosts, **kw):
    return JaxFleetCoordinator(
        JaxFleetConfig(hosts=list(hosts), rpc_retries=0, rpc_deadline=1.0, **kw),
        JaxScanOptions(scanners=["secret"]))


def test_poller_thread_lifecycle():
    """``start`` takes a baseline tick and names its thread after the trace;
    the dead replica scrapes as breaker-open headroom 0 and the live one
    fine; ``stop`` joins the thread, retires every row it set, sets
    ``ctx.fleet`` and is idempotent."""
    httpd, host = replica("port")
    try:
        coord = port_coordinator([host, DEAD])
        ctx = obs.TraceContext(name="tel", enabled=True)
        poller = telemetry.ReplicaPoller(coord, ctx, interval=0.02).start()
        try:
            assert poller.health[host].scrapes >= 1  # the baseline tick
            names = [t.name for t in threading.enumerate()]
            assert f"fleet-telemetry-{ctx.trace_id[:8]}" in names
            deadline = time.monotonic() + 30
            while poller.health[DEAD].scrapes < 3:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            live, gone = poller.health[host], poller.health[DEAD]
            assert live.reachable and live.scrape_failures == 0
            assert not gone.reachable and gone.scrape_failures == gone.scrapes
            assert gone.breaker_open and gone.headroom() == 0.0
            rows = "\n".join(fleet_rows(obs_metrics.REGISTRY))
            assert f'trivy_tpu_fleet_breaker_open{{replica="{DEAD}"}} 1' in rows
            assert f'trivy_tpu_fleet_headroom{{replica="{DEAD}"}} 0' in rows
        finally:
            poller.stop()
        assert not plane_threads() and not fleet_rows(obs_metrics.REGISTRY)
        assert set(ctx.fleet["replicas"]) == {host, DEAD}
        scrapes = ctx.fleet["replicas"][host]["scrapes"]
        poller.stop()
        assert ctx.fleet["replicas"][host]["scrapes"] == scrapes  # no second final tick
    finally:
        shutdown([httpd])


def test_concurrent_fleets_keep_disjoint_gauge_rows():
    servers = [replica("port"), replica("port")]
    pollers = []
    try:
        for _, host in servers:
            p = telemetry.ReplicaPoller(port_coordinator([host]),
                                        obs.TraceContext(name="pair"), interval=0.05)
            p.scrape_once()
            pollers.append(p)
        rows = "\n".join(fleet_rows(obs_metrics.REGISTRY))
        assert all(f'replica="{h}"' in rows for _, h in servers)
        pollers[0].stop()  # fleet A's rows go, fleet B's stay
        rows = "\n".join(fleet_rows(obs_metrics.REGISTRY))
        assert f'replica="{servers[0][1]}"' not in rows and f'replica="{servers[1][1]}"' in rows
    finally:
        for p in pollers:
            p.stop()
        shutdown([h for h, _ in servers])


def test_each_package_scrapes_the_others_server():
    """Both packages' pollers over a port server and over a JAX server: the
    same folded keys on each, every headroom in [0, 1]."""
    servers = {"port": replica("port"), "jax": replica("jax")}
    try:
        for pkg, (_, host) in servers.items():
            coords = (port_coordinator([host]), jax_coordinator([host]))
            mine = telemetry.ReplicaPoller(coords[0], obs.TraceContext(), interval=0.05)
            ref = jax_telemetry.ReplicaPoller(coords[1], jax_obs.TraceContext(), interval=0.05)
            try:
                mine.scrape_once()
                ref.scrape_once()
                a, b = mine.health[host], ref.health[host]
                assert a.reachable and b.reachable, pkg
                assert set(a.last) == set(b.last) and {"queue_depth"} <= set(a.last), pkg
                assert 0.0 <= a.headroom() <= 1.0 and 0.0 <= b.headroom() <= 1.0
            finally:
                mine.stop()
                ref.stop()
    finally:
        shutdown([h for h, _ in servers.values()])


# -- a fleet scan with the plane on ------------------------------------------------


def fleet_surfaces(ctx, exp, hosts) -> dict:
    """The key sets and formats of a telemetry-on scan's exports."""
    mdoc, tdoc = exp.metrics_dict(ctx), exp.timeseries_dict(ctx)
    events = exp.chrome_trace_events(ctx)
    counter_pids = {e["pid"] for e in events
                    if e.get("ph") == "C" and e["pid"] >= 2 + len(ctx.remote)}
    names = [e["args"]["name"] for e in events if e.get("name") == "process_name"
             and e["pid"] in counter_pids]
    reps = tdoc["fleet"]["replicas"]
    return {
        "metrics": sorted(mdoc["fleet"]),
        "metrics_replica": sorted({k for r in mdoc["fleet"]["replicas"].values() for k in r}),
        "timeseries": sorted(tdoc["fleet"]),
        "timeseries_replica": sorted({k for r in reps.values() for k in r}),
        "controller": sorted(tdoc["fleet"]["controller"]),
        "series_doc": sorted({k for r in reps.values() for s in r["series"].values() for k in s}),
        "counter_pids": len(counter_pids),
        "process_names": sorted(n.rsplit(" ", 1)[0] for n in names),
        "status": sorted(ctx.fleet_status()),
    }


def test_fleet_scan_surfaces_equal_jax(env):
    port_servers = [replica("port"), replica("port")]
    jax_servers = [replica("jax"), replica("jax")]
    hosts = [h for _, h in port_servers]
    jhosts = [h for _, h in jax_servers]
    try:
        with obs.scan_context(name="tel", enabled=True) as ctx:
            report, counters, art = port_fleet_scan(env, "fs", hosts, telemetry_interval=0.05)
            assert art.telemetry() == ctx.fleet
        with jax_obs.scan_context(name="tel", enabled=True) as jctx:
            ref, _ = jax_fleet_scan(env, "fs", jhosts, ("secret",), telemetry_interval=0.05)
    finally:
        shutdown([h for h, _ in port_servers + jax_servers])
    assert results(report) and results(report) == results(ref)
    assert not report.degraded
    assert set(ctx.fleet["replicas"]) == set(hosts)
    for rep in ctx.fleet["replicas"].values():
        assert rep["scrapes"] >= 2 and 0.0 <= rep["headroom"] <= 1.0
        assert {"device_busy_ratio", "queue_depth", "headroom"} <= set(rep["summary"])
    mine, theirs = fleet_surfaces(ctx, export, hosts), fleet_surfaces(jctx, jax_export, jhosts)
    assert mine == theirs
    assert mine["counter_pids"] == 2 and mine["process_names"] == ["trivy-tpu fleet replica"] * 2
    assert ctx.fleet["controller"]["ticks"] >= 2
    assert counters["fleet.placement_decisions"] == art.stats()["placement_decisions"]
    # the --live line and the heartbeat read the stopped poller's last tick
    for c in (ctx, jctx):
        assert LIVE.match(c.fleet_live()), c.fleet_live()
        assert isinstance(c.fleet_status()["fleet_mbs"], float)
    assert ctx.fleet_live() in LiveProgress(ctx).line()
    beat = obs.heartbeat(None, "x")
    beat._ctx = ctx
    st = ctx.fleet_status()
    assert (f"fleet {st['shards_done']}/{st['shards_total']} shards, "
            f"{st['healthy']}/{st['replicas']} healthy") in beat._telemetry()
    assert f"{st['fleet_mbs']:.1f} MB/s" in beat._telemetry()


def test_run_at_interval_zero_builds_nothing(env):
    """At interval 0 ``run`` builds neither the poller nor the controller,
    the context gets no fleet doc or ``--live`` fragment, and the heartbeat's
    fleet MB/s is unknown (the plane on is
    ``test_torch_fleet_coordinator.py::test_coordinator_refuses_the_telemetry_plane``)."""
    httpd, host = replica("port")
    shards = port_fs_plan(env, 2)
    try:
        coord = FleetCoordinator(FleetConfig(hosts=[host], telemetry_interval=0.0, speculate=0.0),
                                 ScanOptions(scanners=["secret"]))
        with obs.scan_context(name="run", enabled=True) as ctx:
            blobs = coord.run(shards)
    finally:
        shutdown([httpd])
    assert sorted(blobs) == sorted(s.index for s in shards)
    assert coord.controller is None and coord._poller is None
    assert ctx.fleet is None and ctx.fleet_live is None
    assert ctx.fleet_status()["fleet_mbs"] is None
    assert "fleet" not in export.metrics_dict(ctx) and "fleet" not in export.timeseries_dict(ctx)


def test_interval_zero_imports_nothing_of_the_plane(tmp_path):
    """In a fresh process: a fleet scan at interval 0 (over a dead replica,
    so the local fallback runs) leaves both modules of the plane
    unimported; the same scan at 0.05 imports both."""
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "a.txt").write_text("nothing to see\n")
    (tmp_path / "trivy-secret.yaml").write_text(RESTRICTED)
    code = f"""
import sys
from trivy_tpu_torch import cli
PLANE = ("trivy_tpu_torch.fleet.telemetry", "trivy_tpu_torch.fleet.controller")
for k, interval in enumerate(("0", "0.05")):
    rc = cli.main(["fs", "--device", "cpu", "-q", "--scanners", "secret", "--format", "json",
                   "-o", r"{tmp_path}/out%d.json" % k, "--cache-dir", r"{tmp_path}/c%d" % k,
                   "--fleet", "{DEAD}", "--fleet-telemetry-interval", interval, r"{tree}"])
    assert rc == 0, rc
    loaded = [m for m in PLANE if m in sys.modules]
    assert "trivy_tpu_torch.fleet.coordinator" in sys.modules
    assert loaded == ([] if interval == "0" else list(PLANE)), (interval, loaded)
"""
    subprocess.run([sys.executable, "-c", code], cwd=tmp_path, check=True, timeout=300,
                   env={**os.environ, "PYTHONPATH": str(REPO)})
