"""The port's fleet replica (``trivy_tpu_torch/fleet/plan.py::execute_shard``
behind the port server's ``Shard`` branch, and the port client's
``scan_shard`` and ``submit(shard=)``) held against the JAX replica.

- Executor: each shard of a ``vuln,secret,license --license-full`` plan
  gives the JAX replica's ``BlobID`` and ``BlobInfo``, and so does each
  image-layer shard; a second run of a layer shard is served from the cache
  (``fleet.layer_cache_hits``). A secret-only fs shard finds the JAX
  findings under another key (the port runs only the OS identity analyzers
  there, a deliberate difference), and the JAX key with ``ListAllPkgs``. A
  file deleted after the plan lands in ``Health`` as ``walk.skipped``.
- Server: a shard with an unknown backend answers 400, sync and async,
  and is never queued; a ``misconfig`` shard gives the JAX server's blobs;
  a root or secret config this host cannot see fails the shard loudly
  (500, a failed job).
- The JAX coordinator (``trivy_tpu.fleet.merge.FleetArtifact``) over port
  replicas gives the JAX single-host ``Results``: fs with ``secret``, with
  ``secret,license`` and with ``vuln``, an image of six layers, a replica
  without admission (sync shards), a fleet of one JAX and one port replica,
  a dead port replica (its shards re-dispatched), and a ``WarmHits`` seed
  exported by the port's scanner, after which the replica uploads no row.
- The port's client against a port and a JAX server: ``scan_shard`` and
  ``submit(shard=)`` with ``wait_result`` give equal ``Blobs``;
  ``WantTrace`` returns the ``server.shard`` span under the caller's trace
  id, and a shard job's progress is found under its job id, the first
  job's too (the JAX server has none for it: a reference fault).

Servers run in-process on the CPU, trees and images are small and fixed,
and every blob is compared as its JSON dict: equality is exact. Every
server stops in a ``finally``.
"""

import json
import os
import shutil
import urllib.error
import urllib.request
from collections import Counter

import pytest

from tests.dbtest import build_db
from tests.secret_samples import SAMPLES
from tests.test_fleet import make_image
from tests.test_torch_fs_vuln import make_tree, write
from tests.test_torch_match import few_torch_threads, port_logs_propagate  # noqa: F401
from trivy_tpu import commands as jax_commands
from trivy_tpu.artifact.image import ImageArchiveArtifact as JaxImageArchiveArtifact
from trivy_tpu.artifact.local_fs import LocalFSArtifact as JaxLocalFSArtifact
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.db import VulnDB as JaxVulnDB
from trivy_tpu.fleet import plan as jax_plan
from trivy_tpu.fleet.coordinator import FleetConfig
from trivy_tpu.fleet.merge import FleetArtifact
from trivy_tpu.parallel import mesh as jax_mesh
from trivy_tpu.rpc.admission import resolve_admission as jax_resolve_admission
from trivy_tpu.rpc.server import start_server as jax_start_server
from trivy_tpu.scanner import ScanOptions as JaxScanOptions
from trivy_tpu.scanner import Scanner as JaxScanner
from trivy_tpu.scanner.local_driver import LocalDriver as JaxLocalDriver
from trivy_tpu_torch import obs, rpc
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.fanal.scan import ScanAnalyzers, analyze_files
from trivy_tpu_torch.fanal.walker import FSWalker
from trivy_tpu_torch.fleet import plan
from trivy_tpu_torch.parallel import mesh
from trivy_tpu_torch.rpc.admission import resolve_admission
from trivy_tpu_torch.rpc.client import RemoteDriver, RPCError, get_progress
from trivy_tpu_torch.rpc.server import start_server
from trivy_tpu_torch.scanner import ScanOptions

ALL = ("vuln", "secret", "license")
# the two built-in rules the tree plants: the plain matcher over every
# built-in rule costs seconds per CPU scan
RESTRICTED = "enable-builtin-rules:\n  - github-pat\n  - aws-access-key-id\n"
WAIT = 60.0  # seconds any one wait below may take
APACHE_HEADER = (b"# Licensed under the Apache License, Version 2.0 (the \"License\");\n"
                 b"# you may not use this file except in compliance with the License.\n"
                 b"# You may obtain a copy of the License at\n#\n"
                 b"#     http://www.apache.org/licenses/LICENSE-2.0\n")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The fs-vuln tree of ``tests/test_torch_fs_vuln.py`` with six more
    directories of credentials and a licensed source header, the fixture DB,
    a two-rule secret config and a six-layer image."""
    base = tmp_path_factory.mktemp("fleet")
    root = base / "tree"
    make_tree(root)
    for i in range(6):
        write(root, f"pkg{i:02d}/cred.txt",
              f"svc{i} token {SAMPLES['github-pat']}\n".encode() * (i + 1))
        write(root, f"pkg{i:02d}/data.py", f"print({i})\n".encode() * (40 * (i + 1)))
    write(root, "pkg02/lib.py", APACHE_HEADER + b"print('x')\n")
    cfg = base / "secret.yaml"
    cfg.write_text(RESTRICTED)
    return {"base": base, "tree": root, "cfg": str(cfg), "db": build_db(base),
            "image": make_image(base, n_layers=6)}


def jax_option(env, scanners, backend="cpu"):
    """The JAX CLI's ``ArtifactOption`` for ``scanners`` with
    ``--license-full`` and the two-rule secret config."""
    return jax_commands._artifact_option(None, {
        "backend": backend, "scanners": list(scanners), "license_full": True,
        "secret_config": env["cfg"]})


def jax_scan_options(scanners) -> JaxScanOptions:
    return JaxScanOptions(scanners=list(scanners), license_full=True)


def as_json(doc):
    return json.loads(json.dumps(doc))


def fs_shards(env, scanners=ALL, n=4, root=None):
    shards, _, _ = jax_plan.plan_fs_shards(str(root or env["tree"]), jax_option(env, scanners),
                                           jax_scan_options(scanners), n)
    return shards


def image_shards(env, scanners=ALL):
    jcache = jax_new_cache("memory", None)
    art = JaxImageArchiveArtifact(env["image"], jcache, jax_option(env, scanners))
    return jax_plan.plan_image_shards(art, jcache, jax_scan_options(scanners)).shards


@pytest.fixture(autouse=True)
def clean_breaker_gauges():
    """Each test starts with no row in either package's process-global
    breaker gauge and puts back what was there. A coordinator's breaker
    rows (``fleet:<host>``) stay open after a scan over dead replicas, and
    an in-process server with admission reads a gauge whose every row is
    open as every device dead: busy, it sheds ``/scan/submit`` with 503
    ``breakers-open``, so a test after such a scan in the same process
    falls back to a local, degraded scan. The modules that scan over dead
    replicas import this fixture too."""
    gauges = [jax_mesh._BREAKER_OPEN, mesh._BREAKER_OPEN]
    saved = [dict(g._values) for g in gauges]
    for g in gauges:
        with g._lock:
            g._values.clear()
    yield
    for g, rows in zip(gauges, saved):
        with g._lock:
            g._values.clear()
            g._values.update(rows)


def port_server(admission: bool = True, cache=None):
    adm = resolve_admission({"max_concurrent_scans": 2 if admission else 0})
    return start_server(cache=cache or new_cache("memory"), device="cpu", admission=adm)


def jax_server():
    return jax_start_server(cache=jax_new_cache("memory", None),
                            admission=jax_resolve_admission({"max_concurrent_scans": 2}))


def post(url: str, doc: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- the executor against the JAX replica's --------------------------------------


@pytest.mark.parametrize("n_shards", [1, 4])
def test_fs_shards_equal_jax(env, n_shards):
    shards = fs_shards(env, n=n_shards)
    assert len(shards) == n_shards
    infos = []
    for s in shards:
        ref = jax_plan.execute_shard(s.wire, jax_new_cache("memory", None))
        cache = new_cache("memory")
        got = plan.execute_shard(s.wire, cache, device="cpu")
        assert as_json(got) == as_json(ref), s.label()
        assert cache.get_blob(got[0]["BlobID"]) == got[0]["BlobInfo"]
        infos.append(got[0]["BlobInfo"])
    assert any(i["Secrets"] for i in infos) and any(i["Licenses"] for i in infos)
    assert any(i["Applications"] for i in infos), "a plan without packages proves little"


def test_image_layer_shards_equal_jax_then_cached(env):
    shards = image_shards(env)
    assert len(shards) == 6
    cache = new_cache("memory")
    for s in shards:
        ref = jax_plan.execute_shard(s.wire, jax_new_cache("memory", None))
        got = plan.execute_shard(s.wire, cache, device="cpu")
        assert as_json(got) == as_json(ref), s.label()
        assert got[0]["BlobID"] == s.wire["BlobID"]
    with obs.scan_context(name="again", enabled=True) as ctx:
        again = [plan.execute_shard(s.wire, cache, device="cpu") for s in shards]
    assert ctx.counters["fleet.layer_cache_hits"] == len(shards)
    assert as_json(again) == as_json([[{"BlobID": s.wire["BlobID"],
                                        "BlobInfo": cache.get_blob(s.wire["BlobID"])}]
                                      for s in shards])


def test_secret_only_shard_finds_the_jax_findings_under_another_key(env):
    """The port's secret-only fs scan runs only the OS identity analyzers
    (the deliberate difference of the port's client mode): the blob holds
    the JAX secrets without the packages, under another key. With the
    request's ``ListAllPkgs`` it runs every analyzer, as the JAX replica
    always does, and gives the JAX blob and key."""
    (shard,) = fs_shards(env, ("secret",), n=1)
    (ref,) = jax_plan.execute_shard(shard.wire, jax_new_cache("memory", None))
    (got,) = plan.execute_shard(shard.wire, new_cache("memory"), device="cpu")
    assert got["BlobID"] != ref["BlobID"]
    assert got["BlobInfo"]["Secrets"] == as_json(ref["BlobInfo"]["Secrets"])
    assert got["BlobInfo"]["Secrets"], "no secret found"
    assert ref["BlobInfo"]["Applications"] and not got["BlobInfo"]["Applications"]
    full = plan.execute_shard(shard.wire, new_cache("memory"), device="cpu", list_all_pkgs=True)
    assert as_json(full) == as_json([ref])


def test_a_file_deleted_after_the_plan_is_skipped_in_health(env, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(env["tree"], root)
    (shard,) = fs_shards(env, n=1, root=root)
    os.unlink(root / "pkg03" / "cred.txt")
    ref = jax_plan.execute_shard(shard.wire, jax_new_cache("memory", None))
    httpd, port = port_server(admission=False)
    try:
        resp = RemoteDriver(f"http://127.0.0.1:{port}").scan_shard(
            "t", shard.wire, ScanOptions(scanners=list(ALL)))
    finally:
        httpd.shutdown()
    assert resp["Health"].get("walk.skipped") == 1
    assert resp["Blobs"] == as_json(ref)
    assert not any(s["FilePath"] == "pkg03/cred.txt" for s in resp["Blobs"][0]["BlobInfo"]["Secrets"])


# -- what a port replica refuses and what fails it -------------------------------


@pytest.mark.parametrize("change,match", [
    ({"Backend": "tpu"}, "unknown backend"),
])
def test_unported_shards_answer_400_sync_and_async(env, change, match):
    shard = {**fs_shards(env, n=1)[0].wire, **change}
    httpd, port = port_server()
    try:
        base = f"http://127.0.0.1:{port}"
        for path in (rpc.SCANNER_SCAN, rpc.SCAN_SUBMIT):
            code, doc = post(base + path, {"Target": "t", "Shard": shard})
            assert code == 400 and match in doc["error"], (path, code, doc)
        assert httpd.service.metrics.scans.value() == 0
        assert httpd.service.admission.queue_depth() == 0
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("change", [{"Scanners": ["secret", "misconfig"]}])
def test_a_misconfig_shard_answers_as_the_jax_server_sync_and_async(env, change):
    """The shard that answered 400 before the misconfiguration types were
    all ported: a port and a JAX server answer it sync and as an async job
    with the same ``Blobs``, each scanning every type."""
    shard = {**fs_shards(env, n=1)[0].wire, **change}
    blobs = []
    for make in (port_server, jax_server):
        httpd, port = make()
        try:
            base = f"http://127.0.0.1:{port}"
            code, doc = post(base + rpc.SCANNER_SCAN, {"Target": "t", "Shard": shard})
            assert code == 200, doc
            driver = RemoteDriver(base, retries=0)
            sub = driver.submit("t", "", [], ScanOptions(scanners=list(change["Scanners"])),
                                shard=shard)
            assert driver.wait_result(sub["JobID"], timeout=WAIT)["Blobs"] == doc["Blobs"]
            blobs.append(doc["Blobs"])
        finally:
            httpd.shutdown()
    assert blobs[0] == blobs[1]


def test_a_root_or_config_this_host_lacks_fails_the_shard(env):
    wire = fs_shards(env, n=1)[0].wire
    httpd, port = port_server()
    try:
        base = f"http://127.0.0.1:{port}"
        driver = RemoteDriver(base, retries=0)
        for change, match in (({"Root": "/nonexistent/fleet/root"}, "does not exist"),
                              ({"SecretConfig": "/nonexistent/rules.yaml"}, "secret config")):
            code, doc = post(base + rpc.SCANNER_SCAN, {"Target": "t", "Shard": {**wire, **change}})
            assert code == 500 and match in doc["error"]
            sub = driver.submit("t", "", [], ScanOptions(scanners=list(ALL)),
                                shard={**wire, **change})
            with pytest.raises(RPCError, match=f"failed: .*{match}"):
                driver.wait_result(sub["JobID"], timeout=WAIT)
    finally:
        httpd.shutdown()


# -- the JAX coordinator over port replicas -------------------------------------


def fleet(n_port: int, admission: bool = True, n_jax: int = 0):
    """``n_jax`` JAX and ``n_port`` port replicas; returns (httpds, hosts)."""
    httpds, hosts = [], []
    for make in [jax_server] * n_jax + [lambda: port_server(admission)] * n_port:
        httpd, port = make()
        httpds.append(httpd)
        hosts.append(f"127.0.0.1:{port}")
    return httpds, hosts


def shutdown(httpds) -> None:
    for h in httpds:
        h.shutdown()


def single_host(env, kind: str, scanners):
    """The JAX single-host report of the tree or the image."""
    cache = jax_new_cache("memory", None)
    opt = jax_option(env, scanners)
    if kind == "fs":
        art = JaxLocalFSArtifact(str(env["tree"]), cache, opt)
    else:
        art = JaxImageArchiveArtifact(env["image"], cache, opt)
    db = JaxVulnDB.load(env["db"]) if "vuln" in scanners else None
    return JaxScanner(art, JaxLocalDriver(cache, db)).scan_artifact(jax_scan_options(scanners))


def fleet_scan(env, kind: str, hosts, scanners, backend="cpu", **cfg_kw):
    """The JAX coordinator's scan over ``hosts``: speculation, the telemetry
    plane and the mid-scan split off unless asked for, so a shard slow
    under load adds no scan to the counts the tests compare."""
    cfg_kw.setdefault("speculate", 0.0)
    cfg_kw.setdefault("telemetry_interval", 0.0)
    cfg_kw.setdefault("split_threshold", 0.0)
    cfg = FleetConfig(hosts=list(hosts), **cfg_kw)
    cache = jax_new_cache("memory", None)
    so = jax_scan_options(scanners)
    target = str(env["tree"]) if kind == "fs" else env["image"]
    art = FleetArtifact(kind, target, cache, jax_option(env, scanners, backend), cfg, so)
    db = JaxVulnDB.load(env["db"]) if "vuln" in scanners else None
    return JaxScanner(art, JaxLocalDriver(cache, db)).scan_artifact(so), art


def results(report) -> list:
    return [r.to_dict() for r in report.results]


@pytest.mark.parametrize("scanners", [("secret",), ("secret", "license"), ("vuln",)])
def test_jax_coordinator_over_port_replicas_fs(env, scanners):
    httpds, hosts = fleet(2)
    try:
        report, art = fleet_scan(env, "fs", hosts, scanners)
    finally:
        shutdown(httpds)
    want = single_host(env, "fs", scanners)
    assert results(report) == results(want)
    assert report.results, "parity against an empty report proves nothing"
    assert not report.degraded
    stats = art.stats()
    assert stats["shards"] >= 4
    assert all(stats["replica_shards"][h] > 0 for h in hosts), stats["replica_shards"]
    assert sum(httpd.service.metrics.scans.value() for httpd in httpds) == stats["shards"]


def test_jax_coordinator_over_port_replicas_image(env):
    scanners = ("vuln", "secret", "license")
    httpds, hosts = fleet(2)
    try:
        report, art = fleet_scan(env, "image", hosts, scanners)
    finally:
        shutdown(httpds)
    want = single_host(env, "image", scanners)
    assert results(report) == results(want) and report.results
    assert report.metadata == want.metadata
    assert not any("app0/cred.txt" in r.target for r in report.results)  # the whiteout
    assert art.stats()["shards"] == 6


def test_replica_without_admission_takes_sync_shards(env):
    httpds, hosts = fleet(1, admission=False)
    try:
        report, art = fleet_scan(env, "fs", hosts, ("secret",))
    finally:
        shutdown(httpds)
    assert art.coordinator._sync_only == [True]
    assert results(report) == results(single_host(env, "fs", ("secret",)))


def test_mixed_fleet_of_a_jax_and_a_port_replica(env):
    scanners = ("vuln", "secret", "license")
    httpds, hosts = fleet(1, n_jax=1)
    try:
        report, art = fleet_scan(env, "fs", hosts, scanners)
    finally:
        shutdown(httpds)
    assert results(report) == results(single_host(env, "fs", scanners))
    assert all(v > 0 for v in art.stats()["replica_shards"].values())


def test_dead_port_replica_redispatches(env):
    httpds, hosts = fleet(2)
    httpds[0].shutdown()  # replica 0 is gone before the scan starts
    httpds[0].server_close()
    try:
        report, art = fleet_scan(env, "fs", hosts, ("secret",))
    finally:
        shutdown(httpds[1:])
    assert results(report) == results(single_host(env, "fs", ("secret",)))
    assert not report.degraded
    stats = art.stats()
    assert stats["replica_shards"].get(hosts[0], 0) == 0
    assert stats["replica_shards"][hosts[1]] == stats["shards"]


def test_warm_seed_from_the_port_scanner_serves_every_row(env, monkeypatch):
    """The port's scanner exports its warm hit store; the JAX coordinator
    ships it on the first shard to a port replica, whose scanner then
    uploads no row and serves hits, with the single-host findings."""
    # the coordinator's warm store: the port's scan of the same files in the
    # shard's order (row digests are content-addressed, and small files
    # share rows in feed order)
    (shard,) = fs_shards(env, ("secret",), n=1)
    local = ScanAnalyzers(["secret"], "cpu", config_path=env["cfg"])
    secret, licenses = local.batch(str(env["tree"]))
    analyze_files(FSWalker().walk_paths(str(env["tree"]), shard.wire["Paths"]), str(env["tree"]),
                  local.group, secret, licenses, Counter())
    export = local.scanner.export_warm_hits()
    assert export
    built = []

    class Recording(plan.ScanAnalyzers):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(plan, "ScanAnalyzers", Recording)
    httpds, hosts = fleet(1)
    try:
        report, art = fleet_scan(env, "fs", hosts, ("secret",), backend="auto",
                                 shards_per_replica=1, warm_seed=export)
    finally:
        shutdown(httpds)
    assert art.stats()["warm_seeded"] == 1
    assert results(report) == results(single_host(env, "fs", ("secret",)))
    (analyzers,) = built
    st = analyzers.stats()
    assert st["chunks_uploaded"] == 0 and st["chunks_dedup_hit"] > 0, st


def test_a_seed_of_another_namespace_is_dropped_with_a_warning(env, caplog):
    (shard,) = fs_shards(env, ("secret",), n=1)
    wire = {**shard.wire, "WarmHits": [["secret-hitv0:00:ab", {"r": []}]]}
    with caplog.at_level("WARNING", logger="trivy_tpu_torch"):
        got = plan.execute_shard(wire, new_cache("memory"), device="cpu")
    assert "1 entry dropped" in caplog.text
    assert got == plan.execute_shard(shard.wire, new_cache("memory"), device="cpu")


# -- the port's client against both servers --------------------------------------


@pytest.mark.parametrize("kind", ["fs", "image-layer"])
def test_port_client_sends_shards_to_both_servers(env, kind):
    shards = fs_shards(env, n=2) if kind == "fs" else image_shards(env)[:2]
    opts = ScanOptions(scanners=list(ALL))
    got = {}
    for server_kind, make in (("port", port_server), ("jax", jax_server)):
        httpd, port = make()
        try:
            driver = RemoteDriver(f"http://127.0.0.1:{port}")
            sync = [driver.scan_shard("t", s.wire, opts)["Blobs"] for s in shards]
            subs = [driver.submit("t", "", [], opts, shard=s.wire) for s in shards]
            jobs = [driver.wait_result(sub["JobID"], timeout=WAIT)["Blobs"] for sub in subs]
        finally:
            httpd.shutdown()
        assert jobs == sync
        got[server_kind] = sync
    assert got["port"] == got["jax"]
    assert got["port"] == as_json([jax_plan.execute_shard(s.wire, jax_new_cache("memory", None))
                                   for s in shards])


def test_want_trace_and_progress_of_a_shard_job(env):
    shard = fs_shards(env, n=2)[0]
    opts = ScanOptions(scanners=list(ALL))
    httpd, port = port_server()
    base = f"http://127.0.0.1:{port}"
    try:
        driver = RemoteDriver(base)
        with obs.scan_context(name="coordinator", enabled=True) as ctx:
            resp = driver.scan_shard("t", shard.wire, opts)
            subs = [driver.submit("t", "", [], opts, shard=shard.wire) for _ in range(2)]
            jobs = [driver.wait_result(sub["JobID"], timeout=WAIT) for sub in subs]
        trace = resp["Trace"]
        assert trace["trace_id"] == ctx.trace_id
        rpc_span = next(sp for sp in ctx.events if sp.name == "rpc.scan")
        root = [e for e in trace["events"] if e["name"] == "server.shard"]
        assert len(root) == 1 and trace["root_parent_id"] == rpc_span.span_id
        # both jobs joined the caller's trace; the first took its id as the
        # job id, the second a fresh one
        assert [j["Trace"]["trace_id"] for j in jobs] == [ctx.trace_id] * 2
        assert subs[0]["JobID"] == ctx.trace_id != subs[1]["JobID"]
        for sub in subs:
            prog = get_progress(base, sub["JobID"])
            assert prog["Done"] and prog["FilesScanned"] == len(shard.wire["Paths"])
        assert httpd.service.metrics.scans.value() == 3
    finally:
        httpd.shutdown()


def test_the_first_shard_job_of_a_trace_has_progress_unlike_jax(env):
    """The reference registers a shard job's progress only under a job id
    other than the trace id (``trivy_tpu/rpc/server.py:346-359``), so the
    first shard job of a coordinator's trace, whose job id is that trace id,
    has no progress there (404). The port registers every shard job under
    its job id, never a sync shard."""
    shard = fs_shards(env, n=2)[0]
    opts = ScanOptions(scanners=list(ALL))
    found = {}
    for kind, make in (("port", port_server), ("jax", jax_server)):
        httpd, port = make()
        base = f"http://127.0.0.1:{port}"
        try:
            driver = RemoteDriver(base)
            with obs.scan_context(name="coordinator", enabled=True) as ctx:
                sub = driver.submit("t", "", [], opts, shard=shard.wire)
                driver.wait_result(sub["JobID"], timeout=WAIT)
            assert sub["JobID"] == ctx.trace_id
            try:
                found[kind] = get_progress(base, sub["JobID"])["Done"]
            except RPCError as e:
                found[kind] = str(e)
        finally:
            httpd.shutdown()
    assert found["port"] is True
    assert "404" in found["jax"]
