"""The port's client/server mode (``trivy_tpu_torch/rpc/``) held against the
JAX package: every case of ``tests/test_rpc.py`` against
``start_server(device="cpu")``; the two packages' clients and servers
crossed (the port client against a JAX server and the JAX client against a
port server) on an fs-vuln tree and a secret tree, each equal to both
packages' local scans, with the blob ID the JAX client sends; concurrent
clients through one port server, each equal to its serial scan (the
constraint dispatch's buffers are shared per DB); a DB hot swap that
releases the old join's device bytes; the fleet's register and
deregister seams answering 404 (no coordinator); ``--server`` on ``image``, ``vm`` and ``sbom`` scanning locally
with one warning, as the JAX CLI's do; and the ``server`` command in a
subprocess. Every server stops in a ``finally``, every wait has its own
timeout."""

import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_torch_fs_vuln import make_tree
from tests.test_torch_match import few_torch_threads, port_logs_propagate  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import VERSION, cli, obs, rpc
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import recorder
from trivy_tpu_torch.rpc.client import RemoteCache, RemoteDriver, RPCError
from trivy_tpu_torch.rpc.server import DBReloader, ScanServer, start_server
from trivy_tpu_torch.scanner import ScanOptions
from trivy_tpu_torch.types import Application, BlobInfo, Package

REPO = Path(__file__).resolve().parent.parent
# the two built-in rules the trees plant: the plain matcher over the full
# built-in rules costs seconds per CPU scan
SECRET_CONFIG = "enable-builtin-rules:\n  - github-pat\n  - aws-access-key-id\n"
WAIT = 30.0  # seconds any one wait below may take


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """An fs-vuln tree (every lockfile kind, an alpine root, a secret and a
    license), a secret tree, an alpine tree of one package, the fixture DB,
    and a working directory with the two-rule ``trivy-secret.yaml``."""
    base = tmp_path_factory.mktemp("rpc")
    make_tree(base / "vuln")
    secret = base / "secret"
    (secret / "src").mkdir(parents=True)
    (secret / "src" / "cred.txt").write_text(f"token {SAMPLES['github-pat']}\n")
    (secret / "lib").mkdir()
    (secret / "lib" / "b.env").write_text(f"AWS={SAMPLES['aws-access-key-id']}\n")
    alpine = base / "alpine"
    (alpine / "etc").mkdir(parents=True)
    (alpine / "etc" / "os-release").write_text("ID=alpine\nVERSION_ID=3.18.4\n")
    (alpine / "lib" / "apk" / "db").mkdir(parents=True)
    (alpine / "lib" / "apk" / "db" / "installed").write_text(
        "C:Q1x=\nP:musl\nV:1.2.3-r0\nA:x86_64\n\n")
    wd = base / "wd"
    wd.mkdir()
    (wd / "trivy-secret.yaml").write_text(SECRET_CONFIG)
    return {"vuln": base / "vuln", "secret": secret, "alpine": alpine, "db": build_db(base),
            "wd": wd, "base": base}


@pytest.fixture
def wd(env, tmp_path, monkeypatch):
    monkeypatch.chdir(env["wd"])
    for name in ("SERVER", "TOKEN", "FAULT_INJECT", "MAX_CONCURRENT_SCANS"):
        monkeypatch.delenv(f"TRIVY_TPU_{name}", raising=False)
    return tmp_path


@pytest.fixture
def server(env):
    """A port server on the CPU with the fixture DB."""
    httpd, port = start_server(cache=new_cache("memory"), vuln_client=VulnDB.load(env["db"]),
                               device="cpu")
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        httpd.shutdown()


def client_scan(root, base, scanners=("vuln",), **kw):
    report, stats = cli.scan_fs(str(root), device="cpu", scanners=scanners, server=base,
                                config_path="trivy-secret.yaml", **kw)
    return report, stats


# -- the cases of tests/test_rpc.py -------------------------------------------


def test_healthz_and_version(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=WAIT) as r:
        doc = json.loads(r.read())
    assert doc["Status"] == "ok"
    assert doc["Version"] == VERSION
    assert doc["UptimeSeconds"] >= 0
    assert doc["InFlight"] == 0
    with urllib.request.urlopen(f"{server}/version", timeout=WAIT) as r:
        assert json.loads(r.read())["Version"] == VERSION


def test_metrics_endpoint(server, env, wd):
    """GET /metrics serves Prometheus text fed from the scan registry, and
    the port's parser reads it back."""
    client_scan(env["alpine"], server)
    req = urllib.request.urlopen(f"{server}/metrics", timeout=WAIT)
    assert req.headers["Content-Type"].startswith("text/plain")
    text = req.read().decode()
    assert "trivy_tpu_scans_total 1" in text
    assert "trivy_tpu_requests_in_flight 0" in text
    assert 'trivy_tpu_http_requests_total{method="scan",code="200"} 1' in text
    assert "trivy_tpu_scan_seconds_count 1" in text
    assert "trivy_tpu_cache_hits_total" in text
    assert "trivy_tpu_cache_misses_total" in text
    assert "trivy_tpu_secret_dedup_bytes_total" in text
    assert 'trivy_tpu_stage_seconds_count{stage="driver.apply_layers"} 1' in text
    assert 'trivy_tpu_stage_seconds_count{stage="driver.detect_vulns"} 1' in text
    parsed = obs_metrics.parse_text(text)
    assert parsed["trivy_tpu_scans_total"].kind == "counter"
    assert parsed["trivy_tpu_scans_total"].first() == 1
    assert parsed["trivy_tpu_http_requests_total"].value(method="scan", code="200") == 1
    assert parsed["trivy_tpu_stage_seconds_count"].kind == "histogram"


def test_concurrent_scans_disjoint_trace_contexts():
    """Two concurrent ScanServer.scan calls record into disjoint
    per-request trace contexts."""
    srv = ScanServer(new_cache("memory", None), device="cpu")
    seen: list = []
    barrier = threading.Barrier(2)

    def fake_scan(target, blobs, options):
        ctx = obs.current()
        ctx.count("probe")
        barrier.wait(timeout=5)  # both scans are mid-flight together
        seen.append(ctx)
        return [], None

    srv.driver.scan = fake_scan
    threads = [threading.Thread(target=srv.scan, args=({"Target": f"t{i}"},))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(seen) == 2
    assert seen[0] is not seen[1]
    assert seen[0].trace_id != seen[1].trace_id
    assert seen[0].counters == {"probe": 1}
    assert seen[1].counters == {"probe": 1}
    assert srv.metrics.scans.value() == 2


def test_client_server_fs_scan(server, env, wd):
    """Client-side analysis of an alpine tree, server-side detection."""
    report, stats = client_scan(env["alpine"], server)
    vulns = [v for r in report.results for v in r.vulnerabilities]
    assert {v.vulnerability_id for v in vulns} == {"CVE-2023-0001"}
    assert report.metadata["OS"]["Family"] == "alpine"
    assert stats["remote.blobs_sent"] == 1
    assert "cve.dispatch_count" not in stats  # the join ran on the server


def test_token_auth(tmp_path):
    httpd, port = start_server(cache_dir=str(tmp_path / "c"), token="s3cret", device="cpu")
    try:
        base = f"http://127.0.0.1:{port}"
        bad = RemoteCache(base, token="wrong", retries=0)
        with pytest.raises(RPCError, match="401"):
            bad.missing_blobs("a", ["b"])
        good = RemoteCache(base, token="s3cret", retries=0)
        missing_artifact, missing = good.missing_blobs("a", ["b"])
        assert missing_artifact and missing == ["b"]
    finally:
        httpd.shutdown()


def test_custom_token_header(tmp_path):
    httpd, port = start_server(cache_dir=str(tmp_path / "c"), token="t",
                               token_header="X-Scan-Token", device="cpu")
    try:
        base = f"http://127.0.0.1:{port}"
        ok = RemoteCache(base, token="t", token_header="X-Scan-Token", retries=0)
        assert ok.missing_blobs("x", [])[0] is True
        wrong = RemoteCache(base, token="t", retries=0)
        with pytest.raises(RPCError, match="401"):
            wrong.missing_blobs("x", [])
    finally:
        httpd.shutdown()


def test_retry_then_fail_fast():
    dead = RemoteDriver("http://127.0.0.1:9", retries=1)
    with pytest.raises(RPCError):
        dead.scan("t", "a", [], ScanOptions(scanners=["vuln"]))


def test_cache_round_trip(server):
    cache = RemoteCache(server)
    cache.put_blob("sha256:abc", {"SchemaVersion": 2, "OS": None})
    _, missing = cache.missing_blobs("sha256:art", ["sha256:abc", "sha256:def"])
    assert missing == ["sha256:def"]
    cache.put_artifact("sha256:art", {"SchemaVersion": 2})
    missing_artifact, _ = cache.missing_blobs("sha256:art", [])
    assert missing_artifact is False


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_healthy(base: str, proc) -> dict:
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: {proc.stderr.read()}")
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=1) as r:
                doc = json.loads(r.read())
                if doc.get("Status") == "ok":
                    return doc
        except OSError:
            time.sleep(0.1)
    raise AssertionError("server never became healthy")


def test_cli_client_server_round_trip(env, tmp_path):
    """The whole command line: ``python -m trivy_tpu_torch server`` in a
    subprocess and ``fs --server --token`` as another; SIGTERM drains it and
    it exits 0."""
    port = free_port()
    penv = {k: v for k, v in os.environ.items() if not k.startswith("TRIVY_TPU_")}
    srv = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "server", "--listen", f"127.0.0.1:{port}",
         "--token", "tk", "--cache-dir", str(tmp_path / "srv"), "--device", "cpu", "-q"],
        env=penv, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        assert wait_healthy(base, srv)["Version"] == VERSION
        out = tmp_path / "out.json"
        p = subprocess.run(
            [sys.executable, "-m", "trivy_tpu_torch", "fs", "--scanners", "secret", "--device",
             "cpu", "--format", "json", "-o", str(out), "--cache-dir", str(tmp_path / "cli"),
             "--server", base, "--token", "tk", str(env["secret"])],
            capture_output=True, text=True, env={**penv, "PYTHONPATH": str(REPO)},
            cwd=str(env["wd"]), timeout=120)
        assert p.returncode == 0, p.stderr
        doc = json.loads(out.read_text())
        assert sorted(s["RuleID"] for r in doc["Results"] for s in r["Secrets"]) == [
            "aws-access-key-id", "github-pat"]
        srv.terminate()
        assert srv.wait(timeout=WAIT) == 0
    finally:
        if srv.poll() is None:
            srv.kill()
        srv.wait(timeout=WAIT)
        srv.stdout.close()
        srv.stderr.close()


def test_secret_scanning_stays_client_side(server, env, wd):
    """Secrets are found client-side and ride the blob the server reads."""
    report, _ = client_scan(env["secret"], server, scanners=("secret",))
    assert [r.target for r in report.results] == ["lib/b.env", "src/cred.txt"]
    assert report.results[1].secrets[0].rule_id == "github-pat"


def test_db_reload_swaps_advisories(tmp_path):
    """DB hot swap with in-flight serialization: a reload picks up new
    advisories without restarting the server, after the requests drain."""
    dbdir = tmp_path / "db"
    dbdir.mkdir()
    (dbdir / "advisories.json").write_text(json.dumps({"npm::test": {"lodash": [
        {"VulnerabilityID": "CVE-OLD", "VulnerableVersions": ["<5.0.0"]}]}}))
    srv = ScanServer(new_cache("memory", None), vuln_client=VulnDB.load(str(dbdir)),
                     device="cpu")
    srv.reloader = DBReloader(srv, str(dbdir), interval=9999)
    (dbdir / "advisories.json").write_text(json.dumps({"npm::test": {"lodash": [
        {"VulnerabilityID": "CVE-NEW", "VulnerableVersions": ["<5.0.0"]}]}}))
    srv.reloader.request_begin()  # a request is mid-flight
    done = threading.Event()
    threading.Thread(target=lambda: (srv.reloader.reload(), done.set()), daemon=True).start()
    assert not done.wait(0.3), "reload must wait for in-flight requests"
    srv.reloader.request_end()
    assert done.wait(5), "reload must complete once requests drain"
    advs = srv.driver.vuln_client.get_advisories("npm::test", "lodash")
    assert [a.vulnerability_id for a in advs] == ["CVE-NEW"]


@pytest.mark.parametrize("next_update,stale", [("2020-01-01T00:00:00Z", True),
                                               ("2999-01-01T00:00:00Z", False)],
                         ids=["stale", "fresh"])
def test_db_staleness_warning(tmp_path, caplog, next_update, stale):
    """The server's DB load warns on a stale DB, as the JAX one does."""
    from trivy_tpu_torch.db import load_default_db

    dbdir = tmp_path / "db"
    dbdir.mkdir()
    (dbdir / "advisories.json").write_text("{}")
    (dbdir / "metadata.json").write_text(json.dumps({"Version": 2, "NextUpdate": next_update}))
    with caplog.at_level(logging.WARNING):
        db = load_default_db(str(dbdir), None)
    assert db is not None and db.is_stale() is stale
    assert any("stale" in r.message for r in caplog.records) is stale


# -- the two packages' clients and servers crossed -----------------------------


TREES = {"vuln": ("vuln", "secret", "license"), "secret": ("secret",)}


@pytest.fixture(scope="module")
def local_reports(env):
    """Both packages' local CPU scans of each tree: the reference every
    client/server pairing must give."""
    mp = pytest.MonkeyPatch()
    mp.chdir(env["wd"])
    out = {}
    try:
        for tree, scanners in TREES.items():
            for tag, main, dev in (("port", cli.main, ["--device", "cpu"]),
                                   ("jax", jax_cli.main, ["--backend", "cpu"])):
                o = env["base"] / f"local-{tag}-{tree}.json"
                assert main(["fs", "--scanners", ",".join(scanners), *dev, "--format", "json",
                             "-o", str(o), "-q", "--cache-dir", str(env["base"] / f"lc-{tag}"),
                             "--db-repository", env["db"], str(env[tree])]) == 0
                out[(tag, tree)] = json.loads(o.read_text())
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def servers(env):
    """One port server and one JAX server, each on the CPU with the DB."""
    from trivy_tpu.db import VulnDB as JaxVulnDB
    from trivy_tpu.rpc.server import start_server as jax_start_server

    port_httpd, p1 = start_server(cache_dir=str(env["base"] / "port-srv"),
                                  vuln_client=VulnDB.load(env["db"]), device="cpu")
    try:
        jax_httpd, p2 = jax_start_server(cache_dir=str(env["base"] / "jax-srv"),
                                         vuln_client=JaxVulnDB.load(env["db"]))
        try:
            yield {"port": f"http://127.0.0.1:{p1}", "jax": f"http://127.0.0.1:{p2}",
                   "port_httpd": port_httpd}
        finally:
            jax_httpd.shutdown()
    finally:
        port_httpd.shutdown()


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("client,server_kind", [("port", "port"), ("port", "jax"),
                                                ("jax", "port")])
def test_cross_wire_equals_local_scans(env, wd, local_reports, servers, tree, client,
                                       server_kind):
    out = wd / "out.json"
    main, dev = ((cli.main, ["--device", "cpu"]) if client == "port"
                 else (jax_cli.main, ["--backend", "cpu"]))
    assert main(["fs", "--scanners", ",".join(TREES[tree]), *dev, "--format", "json",
                 "-o", str(out), "-q", "--cache-dir", str(wd / "c"), "--server",
                 servers[server_kind], str(env[tree])]) == 0
    got = json.loads(out.read_text())
    for ref in (local_reports[("port", tree)], local_reports[("jax", tree)]):
        assert got["Results"] == ref["Results"]
        assert got["Metadata"] == ref["Metadata"]
        assert got["ArtifactName"] == ref["ArtifactName"]


@pytest.mark.parametrize("scanners", ["vuln", "vuln,secret,license"])
def test_blob_id_equals_jax_client(env, wd, scanners, tmp_path):
    """The port client sends its blob under the JAX client's key: after the
    port client's scan the JAX client finds nothing to send, and the
    server's cache holds one blob."""
    import trivy_tpu.rpc.client as jax_client

    cache = new_cache("memory")
    httpd, port = start_server(cache=cache, vuln_client=VulnDB.load(env["db"]), device="cpu")
    sent = []
    orig = jax_client.RemoteCache.put_blob
    try:
        base = f"http://127.0.0.1:{port}"
        _, stats = client_scan(env["vuln"], base, scanners=tuple(scanners.split(",")))
        assert stats["remote.blobs_sent"] == 1
        jax_client.RemoteCache.put_blob = lambda self, bid, blob: sent.append(bid)
        out = tmp_path / "jax.json"
        assert jax_cli.main(["fs", "--scanners", scanners, "--backend", "cpu", "--format",
                             "json", "-o", str(out), "-q", "--server", base,
                             str(env["vuln"])]) == 0
        assert sent == []
        assert len(cache._blobs) == 1
    finally:
        jax_client.RemoteCache.put_blob = orig
        httpd.shutdown()


def test_warm_rescan_sends_no_blob(server, env, wd):
    first, s1 = client_scan(env["vuln"], server, scanners=("vuln", "secret"))
    second, s2 = client_scan(env["vuln"], server, scanners=("vuln", "secret"))
    assert (s1["remote.blobs_sent"], s2["remote.blobs_sent"]) == (1, 0)
    assert first.to_dict()["Results"] == second.to_dict()["Results"]


# -- concurrency: one DB, many requests -----------------------------------------

N_PKG = 700  # past the join's BATCH_THRESHOLD (512): the dispatch runs
N_CLIENTS = 9  # more client threads than the CPU cores of a test runner


def conc_db(root: Path) -> str:
    root.mkdir(parents=True, exist_ok=True)
    (root / "advisories.json").write_text(json.dumps({"npm::test": {
        f"pkg{i}": [{"VulnerabilityID": f"CVE-2024-{i:05d}",
                     "VulnerableVersions": [f"<{1 + i % 7}.{i % 5}.0"]}]
        for i in range(N_PKG)}}))
    return str(root)


def conc_blob(t: int) -> dict:
    """Client ``t``'s lockfile set: its own package count and versions, so
    every client's vulnerable set differs."""
    pkgs = [Package(name=f"pkg{i}", version=f"{(i * (t + 3)) % 9}.{(i + t) % 6}.{t}")
            for i in range(N_PKG - 20 * t)]
    return BlobInfo(applications=[Application(
        type="npm", file_path=f"app{t}/package-lock.json", packages=pkgs)]).to_dict()


def test_concurrent_clients_equal_their_serial_scans(tmp_path):
    """Nine clients, each with its own lockfile set of 540-700 packages,
    scan through one port server at once, round after round, with the
    interpreter switching threads often: each result equals that client's
    serial scan. The DB's constraint dispatch reuses one set of buffers,
    which two unguarded scans would overwrite."""
    httpd, port = start_server(cache=new_cache("memory"),
                               vuln_client=VulnDB.load(conc_db(tmp_path / "db")), device="cpu")
    try:
        base = f"http://127.0.0.1:{port}"
        cache = RemoteCache(base)
        for t in range(N_CLIENTS):
            cache.put_blob(f"sha256:{t:064x}", conc_blob(t))

        def scan(t):
            results, _ = RemoteDriver(base).scan(f"t{t}", "", [f"sha256:{t:064x}"],
                                                 ScanOptions(scanners=["vuln"]))
            return [r.to_dict() for r in results]

        serial = {t: scan(t) for t in range(N_CLIENTS)}
        assert all(len(serial[t][0]["Vulnerabilities"]) > 100 for t in serial)
        assert len({json.dumps(v) for v in serial.values()}) == N_CLIENTS
        bad, errors = [], []

        def client(t):
            try:
                for _ in range(6):
                    if scan(t) != serial[t]:
                        bad.append(t)
            except Exception as e:  # the failure detail for the assert below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(N_CLIENTS)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert bad == []
    finally:
        httpd.shutdown()


def test_db_reload_releases_the_resident_join(tmp_path):
    """A swap releases the old DB's resident bound matrix from the flight
    ledger, and only once the guarded request has finished."""
    db_dir = conc_db(tmp_path / "db")
    srv = ScanServer(new_cache("memory", None), vuln_client=VulnDB.load(db_dir), device="cpu")
    srv.cache.put_blob("sha256:a", conc_blob(0))
    srv.reloader = DBReloader(srv, db_dir, interval=9999)
    before = recorder._STATE.resident.get("cve", 0)
    srv.scan({"Target": "t", "BlobIDs": ["sha256:a"], "Options": {"Scanners": ["vuln"]}})
    resident = recorder._STATE.resident.get("cve", 0) - before
    assert resident > 0
    srv.reloader.request_begin()
    done = threading.Event()
    threading.Thread(target=lambda: (srv.reloader.reload(), done.set()), daemon=True).start()
    assert not done.wait(0.3)
    assert recorder._STATE.resident.get("cve", 0) - before == resident
    srv.reloader.request_end()
    assert done.wait(WAIT)
    assert recorder._STATE.resident.get("cve", 0) == before
    # the new DB's join uploads on its first scan
    srv.scan({"Target": "t", "BlobIDs": ["sha256:a"], "Options": {"Scanners": ["vuln"]}})
    assert recorder._STATE.resident.get("cve", 0) - before == resident
    from trivy_tpu_torch.detector.library import release_device

    assert release_device(srv.driver.vuln_client) == resident


# -- what the port's server refuses --------------------------------------------


def test_fleet_seams_answer_404(server):
    for path in (rpc.FLEET_REGISTER, rpc.FLEET_DEREGISTER):
        req = urllib.request.Request(server + path, data=b'{"Host": "127.0.0.1:1"}',
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=WAIT)
        assert ei.value.code == 404


def test_server_on_cuda_without_a_card_fails_at_boot():
    with pytest.raises(RuntimeError, match="CUDA"):
        start_server(cache=new_cache("memory"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ScanServer(new_cache("memory"))


def test_server_command_refuses_unported_and_garbage_settings(monkeypatch, capsys):
    # every JAX flag of the server is ported now: a garbage value of one
    # (the global group's log format) exits 2 as an unported one did
    monkeypatch.setenv("TRIVY_TPU_LOG_FORMAT", "xml")
    with pytest.raises(SystemExit) as exc:
        cli.main(["server", "--device", "cpu", "--listen", "127.0.0.1:9"])
    assert exc.value.code == 2 and "log-format" in capsys.readouterr().err
    monkeypatch.delenv("TRIVY_TPU_LOG_FORMAT")
    monkeypatch.setenv("TRIVY_TPU_MAX_CONCURRENT_SCANS", "banana")
    with pytest.raises(SystemExit) as exc:
        cli.main(["server", "--device", "cpu", "--listen", "127.0.0.1:9"])
    assert exc.value.code == 2 and "max-concurrent-scans" in capsys.readouterr().err
    monkeypatch.delenv("TRIVY_TPU_MAX_CONCURRENT_SCANS")
    assert cli.main(["server", "--device", "cpu", "--listen", "127.0.0.1:9",
                     "--tenants", "a:t"]) == 1  # a quota without a budget


@pytest.mark.parametrize("flags", [["--diff-base", "HEAD~1"], ["--incremental"],
                                   ["--since-last"]], ids=["diff-base", "incremental",
                                                           "since-last"])
@pytest.mark.parametrize("command", ["fs", "rootfs", "repo"])
def test_server_with_diff_base_exits_2(env, wd, command, capsys, flags):
    """The JAX ``_run_fs_like`` refusal and its message, for each of the
    incremental flags."""
    argv = [command, "--device", "cpu", "-q", "--server", "http://127.0.0.1:9", *flags,
            str(env["secret"])]
    assert cli.main(argv) == 2
    assert "require a local scan path (drop --server" in capsys.readouterr().err
    assert jax_cli.main([command, "--backend", "cpu", *argv[3:]]) == 2


@pytest.fixture(scope="module")
def local_targets(env):
    """An image archive and a BOM: the targets whose ``--server`` the JAX
    CLI ignores (``vm`` is covered by its own module's disk)."""
    base = env["base"]
    layer = tar_bytes({"etc/alpine-release": b"3.18.4\n",
                       "lib/apk/db/installed": b"P:musl\nV:1.2.3-r0\nL:MIT\n\n",
                       "app/cred.txt": f"token {SAMPLES['github-pat']}\n".encode()})
    image = docker_save_tar(base / "image.tar", [layer])
    bom = base / "bom.json"
    bom.write_text(json.dumps({"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
        {"type": "library", "name": "lodash", "version": "4.17.15",
         "purl": "pkg:npm/lodash@4.17.15", "licenses": [{"license": {"id": "MIT"}}]}]}))
    vm = None
    mkfs = shutil.which("mkfs.ext4")
    if mkfs is not None:
        vm = base / "disk.img"
        with open(vm, "wb") as f:
            f.truncate(16 << 20)
        subprocess.run([mkfs, "-q", "-d", str(env["alpine"]), str(vm)], check=True, timeout=60)
    return {"image": image, "sbom": str(bom), "vm": vm}


@pytest.mark.parametrize("command", ["image", "vm", "sbom"])
def test_server_on_local_commands_scans_locally(env, wd, local_targets, command, capsys):
    """``--server`` on ``image``, ``vm`` and ``sbom`` is taken and ignored:
    the scan runs locally (the dead address is never contacted) with one
    warning, and the ``Results`` equal the JAX CLI's, which ignores the
    flag too."""
    if local_targets[command] is None:
        pytest.skip("mkfs.ext4 not available")
    scanners = "vuln,license" if command == "sbom" else "vuln,secret"
    tail = ["--scanners", scanners, "--format", "json", "--db-repository", env["db"],
            "--server", "http://127.0.0.1:9", "--token", "t", str(local_targets[command])]
    capsys.readouterr()
    assert cli.main([command, "--device", "cpu", "-o", str(wd / "port.json"),
                     "--cache-dir", str(wd / "c1"), *tail]) == 0
    warned = [ln for ln in capsys.readouterr().err.splitlines() if "--server is ignored" in ln]
    assert len(warned) == 1 and f"ignored by {command}" in warned[0]
    assert jax_cli.main([command, "--backend", "cpu", "-o", str(wd / "jax.json"), "-q",
                         "--cache-dir", str(wd / "c2"), *tail]) == 0
    mine, ref = (json.loads((wd / f"{t}.json").read_text()) for t in ("port", "jax"))
    assert mine["Results"] == ref["Results"] and mine["Results"]
    assert mine["Metadata"] == ref["Metadata"]
