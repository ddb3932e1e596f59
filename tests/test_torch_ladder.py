"""The port's scan ladder held against the JAX package's under the same
fault plans: the per-batch retry and OOM split, the degrade of the secret
feed to the exact host engine, the license classifier's and the CVE join's
fallbacks, the walker's skip accounting, the CLI's ``--fault-inject``,
``--no-host-fallback``, ``--debug-dir``, ``--timeout`` and ``debug``.

These are the port's counterparts of ``tests/test_faults.py``'s tests that
are not about rpc, fleets, redis, admission or misconfiguration, run with
``device="cpu"``, where the fault sites fire around the kernels' plain
versions. ``Results``, ``Degraded`` and the exceptions are compared with
the JAX package's; the batch counters (``batch_retries``,
``batch_splits``, ``degraded``) too, where both scanners have the same row
length and batch and the JAX scanner runs one stream with one batch in
flight (the port's default stream with its window gives the same counts;
``tests/test_torch_feed_streams.py`` holds the ladder under four
streams)."""

from __future__ import annotations

import gzip
import json
import logging
import os
import re
import time

import numpy as np
import pytest

from tests.dbtest import build_db
from tests.secret_samples import SAMPLES
from tests.test_torch_match import port_logs_propagate  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import commands as jax_commands
from trivy_tpu import faults as jfaults
from trivy_tpu import obs as jobs
from trivy_tpu.licensing.classify import LicenseClassifier as JaxClassifier
from trivy_tpu.licensing.fused import FusedLicenseGate as JaxGate
from trivy_tpu.obs import recorder as jrecorder
from trivy_tpu.secret.engine import ScannerConfig as JaxConfig
from trivy_tpu.secret.tpu_scanner import TpuSecretScanner
from trivy_tpu_torch import cli, faults, obs
from trivy_tpu_torch.fanal import walker as twalker
from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
from trivy_tpu_torch.licensing.fused import FusedLicenseGate
from trivy_tpu_torch.obs import recorder as trecorder
from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

GHP = "ghp_" + "A1b2C3d4E5f6G7h8I9j0K1l2M3n4O5p6Q7r8"
RULE_IDS = ["github-pat", "slack-access-token", "jwt-token", "private-key"]
COUNTERS = ("batch_retries", "batch_splits", "degraded")
SECRET_CONFIG = "enable-builtin-rules:\n  - github-pat\n  - aws-access-key-id\n"


@pytest.fixture(autouse=True, scope="module")
def _restore_loggers():
    """``cli.main`` of either package configures its package logger (a
    handler of its own, no propagation, the ``-q`` level); that state is put
    back afterwards, as later modules in the worker read log records
    through pytest's ``caplog``."""
    roots = [logging.getLogger(name) for name in ("trivy_tpu", "trivy_tpu_torch")]
    saved = [(list(r.handlers), r.propagate, r.level) for r in roots]
    yield
    for r, (handlers, propagate, level) in zip(roots, saved):
        r.handlers[:] = handlers
        r.propagate = propagate
        r.setLevel(level)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def cfgs():
    rules = {"enable-builtin-rules": RULE_IDS}
    return ScannerConfig.from_dict(rules), JaxConfig.from_dict(rules)


@pytest.fixture(scope="module")
def corpus():
    """test_faults.py's 40 distinct files (unique noise, so dedup cannot
    absorb the dispatches the fault sites count)."""
    rng = np.random.default_rng(11)
    files = []
    for i in range(40):
        pad = rng.integers(97, 123, size=4000, dtype=np.uint8).tobytes()
        files.append((f"f{i}.txt", b"head\n" + SAMPLES[RULE_IDS[i % 4]].encode() + b"\n" + pad))
    return files


def scanners(cfgs, **kw):
    """The port's and the JAX package's scanners at one batch geometry."""
    kw.setdefault("chunk_len", 1024)
    kw.setdefault("batch_size", 8)
    return (TorchSecretScanner(cfgs[0], device="cpu", **kw),
            TpuSecretScanner(cfgs[1], feed_streams=1, inflight=1, **kw))


def run(mod, obs_mod, scanner, spec: str, files) -> tuple[list, dict, dict]:
    """``files`` through ``scanner`` under ``spec``: the findings, the
    ladder's counters and the health counts the scan added."""
    h0 = obs_mod.current().health_snapshot()
    s0 = scanner.stats.snapshot()
    mod.configure(spec)
    try:
        got = [s.to_dict() for s in scanner.scan_files(files)]
    finally:
        mod.clear()
    s1 = scanner.stats.snapshot()
    h1 = obs_mod.current().health_snapshot()
    return (got, {k: s1[k] - s0[k] for k in COUNTERS},
            {k: v - h0.get(k, 0) for k, v in h1.items() if v != h0.get(k, 0)})


def run_both(cfgs, spec: str, files, **kw):
    port, jax = scanners(cfgs, **kw)
    mine = run(faults, obs, port, spec, files)
    ref = run(jfaults, jobs, jax, spec, files)
    return mine, ref


def oracle(cfgs, files) -> list[dict]:
    exact = SecretScanner(cfgs[0])
    return [exact.scan_bytes(p, d).to_dict() for p, d in files]


# -- rung 1: per-batch retry and OOM halving ----------------------------------


@pytest.mark.parametrize("compress", ["off", "on"])
def test_injected_dispatch_failure_recovers_with_parity(cfgs, corpus, compress):
    mine, ref = run_both(cfgs, "device.dispatch:at=2", corpus, compress=compress)
    assert mine == ref
    assert mine[0] == oracle(cfgs, corpus)
    assert mine[1] == {"batch_retries": 1, "batch_splits": 0, "degraded": 0}
    assert "scan.degraded" not in mine[2]


@pytest.mark.parametrize("compress", ["off", "on"])
def test_oom_shaped_error_halves_the_batch(cfgs, corpus, compress):
    mine, ref = run_both(cfgs, "device.dispatch:at=1:error=oom", corpus, compress=compress)
    assert mine == ref
    assert mine[0] == oracle(cfgs, corpus)
    assert mine[1] == {"batch_retries": 0, "batch_splits": 1, "degraded": 0}


@pytest.mark.parametrize("compress", ["off", "on"])
def test_fetch_failure_redispatches(cfgs, corpus, compress):
    """test_faults.py faults the fetch of one of four round-robin devices;
    the port has one card, ``d0``."""
    mine, ref = run_both(cfgs, "device.fetch@d0:at=1:times=2", corpus, compress=compress,
                         dedup=False)
    assert mine == ref
    assert mine[0] == oracle(cfgs, corpus)
    assert mine[1] == {"batch_retries": 2, "batch_splits": 0, "degraded": 0}


def test_oom_on_a_single_row_batch_retries_it_whole(cfgs):
    """A one-row batch cannot halve: an OOM there walks the retries."""
    files = [("one.txt", SAMPLES["github-pat"].encode() + b"\n" + b"x" * 500)]
    mine, ref = run_both(cfgs, "device.dispatch:times=2:error=oom", files)
    assert mine == ref and mine[1] == {"batch_retries": 2, "batch_splits": 0, "degraded": 0}


def test_slab_returns_to_the_arena_once_on_every_rung(cfgs, corpus, monkeypatch):
    """Retry, split, degrade and the raised cause each end a failed batch's
    slab once: a second release raises in the arena, a missing one is
    counted here."""
    from trivy_tpu_torch.secret import feed

    held = {"n": 0}
    acquire, release = feed.ChunkArena.acquire, feed.ChunkArena.release

    def counted_acquire(self, *a, **k):
        got = acquire(self, *a, **k)
        if got is not None:
            held["n"] += 1
        return got

    def counted_release(self, slab_id):
        release(self, slab_id)
        held["n"] -= 1

    monkeypatch.setattr(feed.ChunkArena, "acquire", counted_acquire)
    monkeypatch.setattr(feed.ChunkArena, "release", counted_release)
    for spec, fallback in (("device.dispatch:at=2", True), ("device.dispatch:at=1:error=oom", True),
                           ("device.fetch@d0:at=3", True), ("device.dispatch:at=3:times=-1", True),
                           ("device.dispatch:at=3:times=-1", False)):
        for compress in ("off", "on"):
            sc = TorchSecretScanner(cfgs[0], chunk_len=1024, batch_size=8, device="cpu",
                                    compress=compress, host_fallback=fallback)
            faults.configure(spec)
            try:
                list(sc.scan_files(corpus))
            except faults.InjectedFault:
                assert not fallback
            faults.clear()
            assert held["n"] == 0, (spec, fallback, compress)


# -- rung 3: graceful degradation to the host path ---------------------------


@pytest.mark.parametrize("compress", ["off", "on"])
def test_all_devices_dead_falls_back_to_host(cfgs, corpus, compress):
    mine, ref = run_both(cfgs, "device.dispatch:times=-1", corpus, compress=compress)
    assert mine == ref
    assert mine[0] == oracle(cfgs, corpus)
    assert mine[1] == {"batch_retries": 2, "batch_splits": 0, "degraded": 1}
    assert mine[2] == {"scan.degraded": 1}


def test_no_host_fallback_raises(cfgs, corpus):
    port, jax = scanners(cfgs, host_fallback=False)
    errors = []
    for mod, sc, kind in ((faults, port, faults.InjectedFault),
                          (jfaults, jax, jfaults.InjectedFault)):
        mod.configure("device.dispatch:times=-1")
        with pytest.raises(kind) as exc:
            list(sc.scan_files(corpus))
        mod.clear()
        errors.append(str(exc.value))
        assert sc.stats.snapshot()["degraded"] == 0
    assert errors[0] == errors[1] == "injected fault at device.dispatch[d0] hit 3"


def test_fallback_mid_stream_preserves_order_and_parity(cfgs):
    """The device path dies while the input stream is half read: files
    resolved, in flight and not yet read all emit, in order, with the
    oracle's findings."""
    rng = np.random.default_rng(3)
    files = []
    for i in range(30):
        pad = rng.integers(97, 123, size=3000, dtype=np.uint8).tobytes()
        files.append((f"s{i}.txt", SAMPLES[RULE_IDS[i % 4]].encode() + b"\n" + pad))
    port, jax = scanners(cfgs, batch_size=4)
    mine = run(faults, obs, port, "device.dispatch:at=4:times=-1", iter(files))
    ref = run(jfaults, jobs, jax, "device.dispatch:at=4:times=-1", iter(files))
    assert mine == ref
    assert mine[0] == oracle(cfgs, files)
    assert mine[1]["degraded"] == 1


def test_real_allocator_oom_splits(cfgs, corpus, monkeypatch):
    """PyTorch's own ``OutOfMemoryError`` (built here, as the allocator
    raises it on the card) splits the batch as the injected kind does."""
    import torch

    sc = TorchSecretScanner(cfgs[0], chunk_len=1024, batch_size=8, device="cpu")
    real = sc.run_batch
    calls = {"n": 0}

    def oom_once(rows, n_live):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 16.00 MiB")
        return real(rows, n_live)

    monkeypatch.setattr(sc, "run_batch", oom_once)
    got = [s.to_dict() for s in sc.scan_files(corpus)]
    assert got == oracle(cfgs, corpus)
    s = sc.stats.snapshot()
    assert (s["batch_splits"], s["batch_retries"], s["degraded"]) == (1, 0, 0)


# -- the license stage ------------------------------------------------------


def findings(per_file) -> list:
    return [[(f.name, f.confidence) for f in fs] for fs in per_file]


def test_license_device_leg_falls_back_to_host():
    texts = [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)[:6]]
    texts += ["no license content here at all"] * 6
    host = JaxClassifier(backend="cpu").classify_batch(texts)
    faults.configure("device.dispatch@license:times=-1")
    jfaults.configure("device.dispatch@license:times=-1")
    with obs.scan_context(name="lic", enabled=True) as ctx:
        mine = LicenseClassifier(device="cpu").classify_batch(texts)
        assert ctx.counters["license.degraded"] == 1
        assert ctx.health_snapshot()["scan.degraded"] == 1
    ref = JaxClassifier(backend="device").classify_batch(texts)
    assert findings(mine) == findings(ref) == findings(host)
    with pytest.raises(faults.InjectedFault) as mine_err:
        LicenseClassifier(device="cpu", host_fallback=False).classify_batch(texts)
    with pytest.raises(jfaults.InjectedFault) as ref_err:
        JaxClassifier(backend="device", host_fallback=False).classify_batch(texts)
    assert str(mine_err.value).split(" hit ")[0] == str(ref_err.value).split(" hit ")[0]


def test_license_fault_mid_batch_degrades_license_only():
    """``device.dispatch@license`` faulting after the first dispatch
    degrades only the license stage: the secret feed (keyed ``d0``) runs on
    under the armed plan and finds what the JAX feed finds."""
    texts = [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)[:8]]
    texts += [FULL_TEXTS["MIT"] + " more filler words here " * 300] * 4
    host = JaxClassifier(backend="cpu").classify_batch(texts)
    files = [(f"t{i}/LICENSE", t.encode()) for i, t in enumerate(texts)]
    files.append(("src/cfg.py", f"token = '{SAMPLES['github-pat']}'\n".encode()))
    spec = "device.dispatch@license:at=2:times=-1"
    rules = {"enable-builtin-rules": ["github-pat"]}

    faults.configure(spec)
    with obs.scan_context(name="chaos-lic", enabled=True) as ctx:
        sc = TorchSecretScanner(ScannerConfig.from_dict(rules), chunk_len=2048, batch_size=8,
                                device="cpu")
        mine_secret = [s.to_dict() for s in sc.scan_files(iter(files),
                                                          license_gate=FusedLicenseGate(True))]
        mine = LicenseClassifier(device="cpu").classify_batch(texts)
        assert ctx.counters.get("license.degraded", 0) >= 1
        assert sc.stats.snapshot()["degraded"] == 0
    jfaults.configure(spec)
    with jobs.scan_context(name="chaos-lic", enabled=True) as jctx:
        jsc = TpuSecretScanner(JaxConfig.from_dict(rules), chunk_len=2048, batch_size=8)
        ref_secret = [s.to_dict() for s in jsc.scan_files(iter(files),
                                                          license_gate=JaxGate(True))]
        ref = JaxClassifier(backend="device").classify_batch(texts)
        assert jctx.counters.get("license.degraded", 0) >= 1
    assert mine_secret == ref_secret and mine_secret[-1]["Findings"]
    assert findings(mine) == findings(ref) == findings(host)


# -- the walker -------------------------------------------------------------


def jax_scan(root: str, cache_dir: str):
    from trivy_tpu.artifact.local_fs import ArtifactOption, LocalFSArtifact
    from trivy_tpu.cache import new_cache
    from trivy_tpu.scanner import ScanOptions, Scanner
    from trivy_tpu.scanner.local_driver import LocalDriver

    cache = new_cache("fs", cache_dir)
    artifact = LocalFSArtifact(root, cache, ArtifactOption(backend="cpu"))
    return artifact, lambda: Scanner(artifact, LocalDriver(cache)).scan_artifact(
        ScanOptions(scanners=["secret"]))


def same_report(mine, ref) -> None:
    a, b = mine.to_dict(), ref.to_dict()
    assert a["Results"] == b["Results"]
    assert a["Metadata"] == b["Metadata"]
    assert a.get("Degraded") == b.get("Degraded")


def test_toctou_file_deleted_between_walk_and_read(tmp_path, monkeypatch):
    """A file vanishes after the walk yields it and before it is read: the
    scan completes, the skip is counted, other findings stand."""

    def tree(root):
        root.mkdir()
        (root / "gh.txt").write_text(f"token {GHP} end\n")
        (root / "victim.txt").write_text("about to vanish\n")
        return root

    real_walk = twalker.FSWalker.walk

    def walk_and_delete(self, root):
        for rel, info, opener in real_walk(self, root):
            if rel == "victim.txt":
                os.remove(os.path.join(root, rel))
            yield rel, info, opener

    monkeypatch.setattr(twalker.FSWalker, "walk", walk_and_delete)
    mine, stats = cli.scan_fs(str(tree(tmp_path / "a")), device="cpu")
    artifact, scan = jax_scan(str(tree(tmp_path / "b")), str(tmp_path / "c"))
    jax_walk = artifact.walker.walk

    def jax_walk_and_delete(root):
        for rel, info, opener in jax_walk(root):
            if rel == "victim.txt":
                os.remove(os.path.join(root, rel))
            yield rel, info, opener

    artifact.walker.walk = jax_walk_and_delete
    ref = scan()
    mine.artifact_name = ref.artifact_name
    same_report(mine, ref)
    assert mine.metadata["SkippedFiles"] == stats["files_skipped"] == 1
    assert not mine.degraded and [r.target for r in mine.results] == ["gh.txt"]


def test_walker_read_fault_counts_skip(tmp_path):
    for root in (tmp_path / "a", tmp_path / "b"):
        root.mkdir()
        (root / "a.txt").write_text("hello world, nothing secret\n")
        (root / "gh.txt").write_text(f"token {GHP} end\n")
    spec = "walker.read@a.txt:times=-1:error=io"
    faults.configure(spec)
    with obs.scan_context(name="walk") as ctx:
        mine, stats = cli.scan_fs(str(tmp_path / "a"), device="cpu")
        assert ctx.health_snapshot()["walk.skipped"] == 1
    jfaults.configure(spec)
    _, scan = jax_scan(str(tmp_path / "b"), str(tmp_path / "c"))
    ref = scan()
    mine.artifact_name = ref.artifact_name
    same_report(mine, ref)
    assert mine.metadata["SkippedFiles"] == stats["files_skipped"] == 1
    assert [r.target for r in mine.results] == ["gh.txt"]


def test_walker_counts_stat_and_walk_errors(tmp_path, monkeypatch):
    from trivy_tpu.fanal.walker import FSWalker as JaxWalker

    (tmp_path / "ok.txt").write_text("x")
    (tmp_path / "gone.txt").write_text("y")
    real_lstat = os.lstat

    def flaky_lstat(path, *a, **kw):
        if str(path).endswith("gone.txt"):
            raise OSError(5, "stat failed")
        return real_lstat(path, *a, **kw)

    monkeypatch.setattr(os, "lstat", flaky_lstat)
    seen = []
    for walker in (twalker.FSWalker(), JaxWalker()):
        seen.append(([rel for rel, _, _ in walker.walk(str(tmp_path))], walker.skipped))
    assert seen[0] == seen[1] == (["ok.txt"], 1)


# -- the CLI ----------------------------------------------------------------


@pytest.fixture
def wd(tmp_path, monkeypatch):
    """A fresh working directory with a two-rule ``trivy-secret.yaml`` (the
    plain matcher then scans a batch in a fraction of the time), no ladder
    setting in the environment, and both flight recorders without a debug
    directory (the flag's is process-wide: put back after the test)."""
    d = tmp_path / "wd"
    d.mkdir()
    (d / "trivy-secret.yaml").write_text(SECRET_CONFIG)
    monkeypatch.chdir(d)
    for name in ("TIMEOUT", "FAULT_INJECT", "NO_HOST_FALLBACK", "DEBUG_DIR", "TUNE"):
        monkeypatch.delenv(f"TRIVY_TPU_{name}", raising=False)
    monkeypatch.setattr(trecorder._STATE, "debug_dir", "")
    monkeypatch.setattr(jrecorder._state(), "debug_dir", "")
    return d


def e2e_tree(root):
    (root / "src").mkdir(parents=True)
    (root / "src" / "gh.txt").write_text(f"token {GHP} end\n")
    (root / "src" / "clean.py").write_text("print('hello')\n")
    (root / "src" / "aws.env").write_text(f"K={SAMPLES['aws-access-key-id']}\n")
    return root


def port_cli(wd, tag: str, target, *args) -> tuple[int, dict | None, dict | None]:
    out, st = wd / f"{tag}.json", wd / f"{tag}.stats.json"
    rc = cli.main(["fs", "--scanners", "secret", "--device", "cpu", "--format", "json",
                   "-o", str(out), "--stats-out", str(st), "--cache-dir", str(wd / tag),
                   *args, str(target)])
    return (rc, json.loads(out.read_text()) if out.exists() else None,
            json.loads(st.read_text()) if st.exists() else None)


def jax_run(wd, tag: str, target, *args, head=("fs", "--scanners", "secret", "--backend",
                                                "auto")) -> tuple[int, dict | None]:
    out = wd / f"{tag}.json"
    rc = jax_cli.main([*head, "--format", "json", "-o", str(out), "--cache-dir", str(wd / tag),
                       *args, str(target)])
    return rc, json.loads(out.read_text()) if out.exists() else None


def test_e2e_fs_all_devices_dead_host_fallback(wd, capsys):
    """With every dispatch scripted dead, the fs scan completes on the host
    with the JAX CLI's findings and ``"Degraded": true``."""
    tree = e2e_tree(wd / "tree")
    rc, mine, stats = port_cli(wd, "dead", tree, "--fault-inject", "device.dispatch:times=-1")
    jrc, ref = jax_run(wd, "jdead", tree, "--fault-inject", "device.dispatch:times=-1")
    assert rc == jrc == 0
    assert mine["Degraded"] is ref["Degraded"] is True
    assert mine["Results"] == ref["Results"] and mine["Results"]
    assert stats["degraded"] == stats["scan.degraded"] == 1 and stats["batch_retries"] == 2
    assert "host confirm path" in capsys.readouterr().err
    assert not faults.active() and not jfaults.active()  # disarmed after the command
    rc, clean, stats = port_cli(wd, "clean", tree)
    assert rc == 0 and "Degraded" not in clean and clean["Results"] == mine["Results"]
    assert stats["degraded"] == stats["batch_retries"] == 0


def test_no_host_fallback_fails_the_command(wd):
    tree = e2e_tree(wd / "tree")
    with pytest.raises(faults.InjectedFault):
        port_cli(wd, "loud", tree, "--fault-inject", "device.dispatch:times=-1",
                 "--no-host-fallback")
    with pytest.raises(jfaults.InjectedFault):
        jax_run(wd, "jloud", tree, "--fault-inject", "device.dispatch:times=-1",
                "--no-host-fallback")
    assert not (wd / "loud.json").exists() and not (wd / "jloud.json").exists()


def test_bad_fault_spec_exits_2(wd):
    tree = e2e_tree(wd / "tree")
    with pytest.raises(SystemExit) as exc:
        port_cli(wd, "bad", tree, "--fault-inject", "device.dispatch:wat=1")
    assert exc.value.code == 2
    assert jax_run(wd, "jbad", tree, "--fault-inject", "device.dispatch:wat=1")[0] == 2


VOLATILE = [
    (re.compile(r"Scan [0-9a-f]{8}"), "Scan <trace>"),
    (re.compile(r"at \d{4}-\d\d-\d\dT[0-9:.+]+"), "at <time>"),
    (re.compile(r"\(\+[0-9.]+s into the scan\)"), "(+<s> into the scan)"),
    (re.compile(r" Device lane: .*"), ""),
]


def verdict_shape(text: str) -> str:
    for pat, rep in VOLATILE:
        text = pat.sub(rep, text)
    return text


def test_degraded_bundle_has_the_jax_verdict_and_keys(wd, capsys):
    """Each package's degraded completion writes one bundle; the port's has
    the JAX bundle's keys, the ``tuning`` block included, and the same
    verdict, once the trace id, the clock and the compile summary are set
    aside. Both CLIs' ``debug`` render the port's bundle alike."""
    tree = e2e_tree(wd / "tree")
    dirs = wd / "port-bundles", wd / "jax-bundles"
    port_cli(wd, "dead", tree, "--fault-inject", "device.dispatch:times=-1",
             "--debug-dir", str(dirs[0]))
    jax_run(wd, "jdead", tree, "--fault-inject", "device.dispatch:times=-1",
            "--debug-dir", str(dirs[1]), head=("fs", "--scanners", "secret", "--backend", "auto",
                                               "--secret-streams", "1", "--secret-inflight", "1"))
    (mine,) = dirs[0].glob("bundle-*-degraded-completion.json.gz")
    (ref,) = dirs[1].glob("bundle-*-degraded-completion.json.gz")
    a, b = trecorder.read_bundle(str(mine)), jrecorder.read_bundle(str(ref))
    skip = {"process_events"}
    assert set(a) - skip == set(b) - skip
    assert set(a["tuning"]["config"]) == set(b["tuning"]["config"])
    assert a["schema"] == b["schema"] == "trivy-tpu-debug-bundle/v1"
    assert a["reason"] == b["reason"] == "degraded-completion"
    assert verdict_shape(a["verdict"]) == verdict_shape(b["verdict"])
    assert "First anomalous event: fault device.dispatch@d0" in a["verdict"]
    assert a["health"] == b["health"] == {"scan.degraded": 1}
    assert set(a["device"]) >= {"compiles", "hbm", "shape_buckets"} and "card" not in a["device"]
    capsys.readouterr()
    assert cli.main(["debug", str(mine)]) == 0
    rendered = capsys.readouterr().out
    assert jax_cli.main(["debug", str(mine)]) == 0
    assert capsys.readouterr().out == rendered
    assert "verdict" in rendered and "timeline" in rendered and "device lane" in rendered
    # a clean scan writes none
    port_cli(wd, "clean", tree, "--debug-dir", str(dirs[0]))
    assert len(list(dirs[0].iterdir())) == 1


def test_terminal_failure_bundle_and_debug_exit_codes(wd, capsys):
    tree = e2e_tree(wd / "tree")
    d = wd / "bundles"
    with pytest.raises(faults.InjectedFault):
        port_cli(wd, "loud", tree, "--fault-inject", "device.dispatch:times=-1",
                 "--no-host-fallback", "--debug-dir", str(d))
    (bundle,) = d.glob("bundle-*-terminal-failure.json.gz")
    doc = trecorder.read_bundle(str(bundle))
    assert doc["error"] == "injected fault at device.dispatch[d0] hit 3"
    assert cli.main(["debug", str(bundle)]) == 0
    assert cli.main(["debug", str(wd / "missing.json.gz")]) == 1
    with gzip.open(bundle, "rt") as f:
        assert json.load(f)["schema"] == "trivy-tpu-debug-bundle/v1"


def test_timeout_exits_1(wd, monkeypatch, capsys):
    """A scan past ``--timeout`` exits 1 in both CLIs, and the alarm is off
    after the command."""
    import signal

    tree = e2e_tree(wd / "tree")
    real = cli.scan_fs

    def slow(*a, **kw):
        time.sleep(5)
        return real(*a, **kw)

    monkeypatch.setattr(cli, "scan_fs", slow)
    monkeypatch.setattr(jax_commands, "_run_fs_like", lambda *a, **kw: time.sleep(5) or 0)
    t0 = time.monotonic()
    assert port_cli(wd, "slow", tree, "--timeout", "1")[0] == 1
    assert jax_run(wd, "jslow", tree, "--timeout", "1")[0] == 1
    assert time.monotonic() - t0 < 4.5
    assert "scan exceeded --timeout=1s" in capsys.readouterr().err
    assert signal.alarm(0) == 0


def test_ladder_settings_resolve_from_env_and_config(wd, monkeypatch):
    """``TRIVY_TPU_FAULT_INJECT``, ``TRIVY_TPU_NO_HOST_FALLBACK``,
    ``TRIVY_TPU_DEBUG_DIR``, ``TRIVY_TPU_TIMEOUT`` and their config keys
    resolve in the port as in the JAX CLI; a JAX flag the port still lacks
    exits 2."""
    tree = e2e_tree(wd / "tree")
    monkeypatch.setenv("TRIVY_TPU_FAULT_INJECT", "device.dispatch:times=-1")
    monkeypatch.setenv("TRIVY_TPU_DEBUG_DIR", str(wd / "env-bundles"))
    rc, mine, _ = port_cli(wd, "env", tree)
    jrc, ref = jax_run(wd, "jenv", tree)
    assert rc == jrc == 0 and mine["Degraded"] is ref["Degraded"] is True
    assert len(list((wd / "env-bundles").glob("bundle-*-degraded-completion.json.gz"))) == 2
    monkeypatch.setenv("TRIVY_TPU_NO_HOST_FALLBACK", "true")
    with pytest.raises(faults.InjectedFault):
        port_cli(wd, "env-loud", tree)
    with pytest.raises(jfaults.InjectedFault):
        jax_run(wd, "jenv-loud", tree)
    for name in ("FAULT_INJECT", "NO_HOST_FALLBACK", "DEBUG_DIR"):
        monkeypatch.delenv(f"TRIVY_TPU_{name}")
    (wd / "trivy-tpu.yaml").write_text(
        "fault-inject: device.dispatch:times=-1\nscan:\n  no-host-fallback: true\n")
    with pytest.raises(faults.InjectedFault):
        port_cli(wd, "cfg-loud", tree)
    (wd / "trivy-tpu.yaml").write_text(
        f"fault-inject: device.dispatch:times=-1\ndebug:\n  dir: {wd / 'cfg-bundles'}\n")
    rc, mine, _ = port_cli(wd, "cfg", tree)
    assert rc == 0 and mine["Degraded"] is True
    assert len(list((wd / "cfg-bundles").iterdir())) == 1
    (wd / "trivy-tpu.yaml").write_text("timeout: 1\n")
    monkeypatch.setattr(cli, "scan_fs", lambda *a, **kw: time.sleep(5))
    assert port_cli(wd, "cfg-slow", tree)[0] == 1
    (wd / "trivy-tpu.yaml").unlink()
    monkeypatch.setenv("TRIVY_TPU_TIMEOUT", "1")
    assert port_cli(wd, "env-slow", tree)[0] == 1
    monkeypatch.delenv("TRIVY_TPU_TIMEOUT")
    # --fleet from the environment runs the fleet, its telemetry plane at
    # the default interval (1.0): the dead replica's shards run here
    monkeypatch.setenv("TRIVY_TPU_FLEET", "127.0.0.1:9")
    rc, mine, st = port_cli(wd, "fleet", tree)
    assert rc == 0 and mine["Degraded"] is True
    assert st["fleet.local_fallback"] == st["fleet.shards"] > 0


def test_license_stage_degrades_in_a_fused_cli_scan(wd):
    """``fs --scanners secret,license --license-full`` with the license
    dispatches dead after the first: ``license.degraded`` counted, the
    findings the unfaulted scan gives, the report ``Degraded``."""
    tree = wd / "tree"
    for i, k in enumerate(sorted(FULL_TEXTS)[:10]):
        p = tree / f"lic{i}" / "LICENSE"
        p.parent.mkdir(parents=True)
        p.write_text(FULL_TEXTS[k])
    (tree / "src").mkdir()
    (tree / "src" / "key.py").write_text(f"# SPDX-License-Identifier: MIT\nk = '{GHP}'\n")
    args = ("--scanners", "secret,license", "--license-full")
    rc0, base, s0 = port_cli(wd, "base", tree, *args)
    rc, doc, st = port_cli(wd, "lic", tree, *args, "--fault-inject",
                           "device.dispatch@license:at=2:times=-1")
    assert rc0 == rc == 0 and s0["license.degraded"] == 0 and "Degraded" not in base
    assert st["license.degraded"] >= 1 and st["degraded"] == 0 and doc["Degraded"] is True
    assert doc["Results"] == base["Results"]
    kinds = {r["Class"] for r in doc["Results"]}
    assert {"secret", "license-file"} <= kinds


def test_cve_join_degrades_in_an_sbom_scan(wd):
    """``sbom`` with the join's dispatch dead: ``cve.degraded`` 1, the
    vulnerabilities of the unfaulted scan. The port marks the report
    ``Degraded``; the JAX CLI counts the degrade without marking it (the
    deliberate difference in ROADMAP's Queue C)."""
    rng = np.random.default_rng(7)
    # past the join's BATCH_THRESHOLD (512 packages), so it dispatches
    components = [{"type": "library", "name": n, "version": v, "purl": f"pkg:npm/{n}@{v}"}
                  for n, v in {(str(rng.choice(["lodash", "minimist", "other"])),
                                f"{rng.integers(0, 5)}.{rng.integers(0, 21)}.{rng.integers(0, 26)}")
                               for _ in range(900)}]
    db = build_db(wd / "db")
    bom = wd / "bom.json"
    bom.write_text(json.dumps({"bomFormat": "CycloneDX", "specVersion": "1.5",
                               "components": sorted(components, key=lambda c: c["purl"])}))

    def port_sbom(tag, *extra):
        out, st = wd / f"{tag}.json", wd / f"{tag}.stats.json"
        rc = cli.main(["sbom", "--device", "cpu", "--format", "json", "-o", str(out),
                       "--stats-out", str(st), "--db-repository", db,
                       "--cache-dir", str(wd / tag), *extra, str(bom)])
        return rc, json.loads(out.read_text()), json.loads(st.read_text())

    rc0, base, s0 = port_sbom("base")
    assert rc0 == 0 and s0["cve.dispatch_count"] == 1 and s0["cve.degraded"] == 0
    rc, doc, st = port_sbom("dead", "--fault-inject", "device.dispatch@cve:times=-1")
    jrc, ref = jax_run(wd, "jdead", bom, "--db-repository", db, "--fault-inject",
                       "device.dispatch@cve:times=-1", head=("sbom",))
    assert rc == jrc == 0
    assert st["cve.degraded"] == 1 and st["scan.degraded"] == 1 and doc["Degraded"] is True
    assert doc["Results"] == base["Results"] == ref["Results"] and doc["Results"]
    assert "Degraded" not in ref
    with pytest.raises(faults.InjectedFault):
        port_sbom("loud", "--fault-inject", "device.dispatch@cve:times=-1", "--no-host-fallback")


def test_timeout_in_a_read_is_not_taken_for_an_unreadable_file(wd, monkeypatch):
    """``--timeout``'s alarm can go off while a file is read. Python's
    ``TimeoutError`` is an ``OSError``, so the JAX CLI's read handler takes
    it for an unreadable file and the scan goes on (exit 0,
    ``SkippedFiles``: the fault in the reference that ROADMAP's Queue C
    records); the port's alarm is no ``Exception`` and exits 1."""
    from trivy_tpu.fanal import walker as jwalker

    tree = e2e_tree(wd / "tree")

    def alarm_in_read(mod, make):
        real = mod.FSWalker.walk

        def walk(self, root):
            for rel, info, opener in real(self, root):
                if rel.endswith("clean.py"):
                    def opener(msg="scan exceeded --timeout=300s"):
                        raise make(msg)
                yield rel, info, opener

        monkeypatch.setattr(mod.FSWalker, "walk", walk)

    alarm_in_read(twalker, cli.ScanTimeout)
    alarm_in_read(jwalker, TimeoutError)
    rc, doc, _ = port_cli(wd, "port", tree)
    jrc, ref = jax_run(wd, "jax", tree)
    assert rc == 1 and doc is None
    assert jrc == 0 and ref["Metadata"]["SkippedFiles"] == 1
