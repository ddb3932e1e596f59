"""The port's dedup hit store, zero gate and feed options against the JAX
package's.

``TorchSecretScanner(device="cpu")`` runs the same feed as
``TpuSecretScanner``: with compression on and off, its findings equal the
exact engine's and every counter equals the JAX scanner's on the same
input; its ruleset fingerprint, row digests and persisted verdict documents
are the JAX scanner's byte for byte, so either package's store serves the
other. The JAX package's dedup tests are mirrored here, and the ``fs``
command's feed flags are held against ``trivy_tpu.cli --backend cpu``.
"""

import json
import logging
import sys
import threading

import pytest

from tests.secret_samples import SAMPLES
from tests.test_dedup_pack import RESTRICTED, dup_fixture
from tests.test_torch_cli import make_tree
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.secret.engine import ScannerConfig as JaxConfig
from trivy_tpu.secret.engine import SecretScanner as JaxEngine
from trivy_tpu.secret.hitstore import HitStore as JaxHitStore
from trivy_tpu.secret.tpu_scanner import TpuSecretScanner
from trivy_tpu_torch import cli
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.secret.engine import ScannerConfig
from trivy_tpu_torch.secret.hitstore import HitStore
from trivy_tpu_torch.secret.scanner import ScanStats, TorchSecretScanner

GHP = SAMPLES["github-pat"]


def build(cfg=RESTRICTED, chunk_len=2048, batch_size=8, **kw):
    return TorchSecretScanner(ScannerConfig.from_dict(cfg), chunk_len=chunk_len,
                              batch_size=batch_size, device="cpu", **kw)


def jax_build(cfg=RESTRICTED, chunk_len=2048, batch_size=8, **kw):
    return TpuSecretScanner(JaxConfig.from_dict(cfg), chunk_len=chunk_len,
                            batch_size=batch_size, backend="xla", **kw)


@pytest.fixture(scope="module")
def cpu():
    return JaxEngine(JaxConfig.from_dict(RESTRICTED))


def assert_parity(cpu, scanner, files):
    got = list(scanner.scan_files(files))
    assert len(got) == len(files)
    for (path, data), secret in zip(files, got):
        assert secret.to_dict() == cpu.scan_bytes(path, data).to_dict(), path
    return got


def zero_files():
    """Zero-filled files: multi-row ones (every row all-zero, and a tail
    row), small ones that ride single-file pack rows, a text file with a
    zero hole, and a planted secret after a hole."""
    hole = b"head line of text\n" * 30 + b"\0" * 9000 + b"tail line of text\n" * 30
    return [
        ("z/a.img", b"\0" * 8192),
        ("z/b.img", b"\0" * 5000),
        ("z/s1.bin", b"\0" * 100),
        ("z/s2.bin", b"\0" * 100),
        ("z/hole.txt", hole),
        ("z/tok.txt", b"\0" * 4096 + f"\n{GHP}\n".encode()),
        ("z/c.img", b"\0" * 8192),
    ]


NEW_FIELDS = [f for f in ScanStats.FIELDS if f not in (
    "rows", "batches", "rows_prefilter_hit", "rows_nfa_skipped", "batches_nfa_skipped")]


@pytest.mark.parametrize("compress", ["on", "off"])
@pytest.mark.parametrize("corpus", ["duplicates", "zeros"])
def test_feed_parity_and_counters_equal_jax(cpu, compress, corpus):
    files = dup_fixture() if corpus == "duplicates" else zero_files()
    port, ref = build(compress=compress), jax_build(compress=compress)
    got = assert_parity(cpu, port, files)
    assert_parity(cpu, ref, files)
    mine, theirs = port.stats.snapshot(), ref.stats.snapshot()
    assert {f: mine[f] for f in NEW_FIELDS} == {f: theirs[f] for f in NEW_FIELDS}
    assert mine["chunks_dedup_hit"] > 0
    if corpus == "duplicates":
        assert mine["rows_packed"] > 0 and mine["files_packed"] > 1
        assert sum(len(s.findings) for s in got) == 4  # 2 secrets x 2 copies
    else:
        assert (mine["chunks_gated_zero"] > 0) == (compress == "on")
        assert any(s.findings for s in got)


def test_fingerprint_and_row_digests_equal_jax(tmp_path):
    """Built-in rules and a --secret-config file, at two row lengths: the
    fingerprints agree, and scans persist the same keys and documents."""
    cfg = tmp_path / "rules.yaml"
    cfg.write_text("rules:\n  - id: zzz-token\n    regex: zzz_[0-9a-f]{8}\n"
                   "    keywords: [zzz_]\n    severity: HIGH\n")
    files = dup_fixture() + [("y/z.txt", b"x zzz_0123abcd y\n" * 40)] + zero_files()
    for port_cfg, jax_cfg, chunk_len in (
        (None, None, 1024),
        (ScannerConfig.from_yaml_file(str(cfg)), JaxConfig.from_yaml_file(str(cfg)), 2048),
    ):
        assert port_cfg is None or port_cfg.source_digest == jax_cfg.source_digest != ""
        mine, theirs = new_cache("memory"), jax_new_cache("memory")
        port = TorchSecretScanner(port_cfg, chunk_len=chunk_len, batch_size=8,
                                  device="cpu", hit_cache=mine, compress="on")
        ref = TpuSecretScanner(jax_cfg, chunk_len=chunk_len, batch_size=8,
                               backend="xla", hit_cache=theirs, compress="on")
        assert port.ruleset_fingerprint == ref.ruleset_fingerprint
        list(port.scan_files(files))
        list(ref.scan_files(files))
        assert mine._blobs == theirs._blobs
        assert len(mine._blobs) > 10


def test_persisted_docs_are_read_by_the_jax_store(cpu, tmp_path):
    port = build(hit_cache=new_cache("fs", str(tmp_path)))
    files = dup_fixture()
    assert_parity(cpu, port, files)
    backend = new_cache("fs", str(tmp_path))
    keys = [bytes.fromhex(k.rsplit(":", 1)[1])
            for k in backend.warm_blobs(port._hit_store.prefix, 10_000)]
    assert keys
    store = JaxHitStore(port.ruleset_fingerprint, backend=jax_new_cache("fs", str(tmp_path)))
    found = store.lookup_batch(keys)
    assert len(found) == len(keys)
    assert all(found[k] == port._hit_store.get(k) for k in keys)
    ref = jax_build(hit_cache=jax_new_cache("fs", str(tmp_path)))
    assert_parity(cpu, ref, files)
    assert ref.stats.snapshot()["chunks_uploaded"] == 0


# -- mirrors of tests/test_dedup_pack.py ------------------------------------


def test_dedup_warm_scan_uploads_nothing(cpu):
    t = build()
    files = dup_fixture()
    list(t.scan_files(files))
    before = t.stats.snapshot()
    assert_parity(cpu, t, files)
    after = t.stats.snapshot()
    assert after["chunks_uploaded"] == before["chunks_uploaded"]
    assert after["bytes_uploaded"] == before["bytes_uploaded"]


def test_ruleset_fingerprint_invalidation():
    """As the JAX test, without its prefilter-off leg: the port has no
    option to turn the prefilter off."""
    rule1 = {"id": "r1", "regex": r"tok_[0-9a-f]{12}", "keywords": ["tok_"], "severity": "HIGH"}
    rule2 = {"id": "r2", "regex": r"sec_[0-9a-f]{12}", "keywords": ["sec_"], "severity": "HIGH"}
    base = dict(RESTRICTED, rules=[rule1])
    plus = dict(RESTRICTED, rules=[rule1, rule2])
    minus = dict(base, **{"disable-rules": ["github-pat"]})
    kw_edit = dict(RESTRICTED, rules=[dict(rule1, keywords=["tok_", "Tok2_"])])
    a, b, c, d, g = (build(cfg, chunk_len=1024, batch_size=4)
                     for cfg in (base, plus, base, minus, kw_edit))
    e = build(base, chunk_len=2048, batch_size=4)
    assert a.ruleset_fingerprint != b.ruleset_fingerprint  # rule added
    assert a.ruleset_fingerprint == c.ruleset_fingerprint  # same ruleset
    assert a.ruleset_fingerprint != d.ruleset_fingerprint  # rule removed
    assert a.ruleset_fingerprint != e.ruleset_fingerprint  # row shape differs
    assert a.ruleset_fingerprint != g.ruleset_fingerprint  # keyword edit
    assert a.compiled.prefilter_fingerprint() == c.compiled.prefilter_fingerprint()
    assert a.compiled.prefilter_fingerprint() != g.compiled.prefilter_fingerprint()


def test_persisted_cache_isolated_by_fingerprint():
    shared = new_cache("memory")
    with_rule = dict(RESTRICTED, rules=[
        {"id": "zzz-token", "regex": r"zzz_[0-9a-f]{8}", "keywords": ["zzz_"],
         "severity": "HIGH"}])
    files = [("src/t.txt", b"x zzz_0123abcd y\n" + b"pad\n" * 40)]
    got_a = list(build(with_rule, chunk_len=1024, batch_size=4, hit_cache=shared)
                 .scan_files(files))
    assert any(f.rule_id == "zzz-token" for f in got_a[0].findings)
    without = JaxEngine(JaxConfig.from_dict(RESTRICTED))
    b = build(chunk_len=1024, batch_size=4, hit_cache=shared)
    assert not assert_parity(without, b, files)[0].findings
    assert b.stats.snapshot()["chunks_dedup_hit"] == 0
    c = build(chunk_len=1024, batch_size=4, hit_cache=shared)
    assert_parity(without, c, files)
    s = c.stats.snapshot()
    assert s["chunks_uploaded"] == 0 and s["chunks_dedup_hit"] > 0


def test_lone_small_file_does_not_stall_emission():
    consumed = []
    big = b"filler line\n" * 2000  # multi-row at chunk_len=2048

    def gen():
        yield ("src/tiny.cfg", b"just a small file\n")
        for i in range(64):
            consumed.append(i)
            yield (f"src/big_{i}.dat", big + str(i).encode())

    it = build().scan_files(gen())
    assert next(it).file_path == "src/tiny.cfg"
    assert len(consumed) < 64  # resolved mid-stream, not at the final drain
    it.close()


def test_generator_close_early_with_cache(cpu):
    t = build(hit_cache=new_cache("memory"))
    files = dup_fixture()
    it = t.scan_files(iter(files))
    first = next(it)
    it.close()  # the pipeline shuts down cleanly mid-scan
    assert first.to_dict() == cpu.scan_bytes(*files[0]).to_dict()
    assert_parity(cpu, t, files)  # and the scanner and its store keep working


def test_empty_file_skips_device(cpu):
    t = build()
    assert_parity(cpu, t, [("e.txt", b""), ("f.txt", b"hello world, nothing secret\n")])
    assert t.stats.snapshot()["chunks"] == 1


def test_dedup_disabled_still_parity(cpu):
    t = build(dedup=False, compress="off")
    assert_parity(cpu, t, dup_fixture())
    s = t.stats.snapshot()
    assert s["chunks_dedup_hit"] == 0 and s["chunks_uploaded"] == s["chunks"]


def test_coalescing_under_thread_switch_stress(cpu):
    """The feeder and the device worker share the waiting-row table and the
    store. With the interpreter switching threads every microsecond and
    many identical rows in flight, no row may be lost or counted twice:
    every row is either uploaded or served by dedup, and findings hold."""
    body = b"int x;\n" * 700 + SAMPLES["slack-access-token"].encode() + b"\n"
    files = [(f"v{i % 5}/gen_{i}.c", body + b"// %d\n" % (i % 3)) for i in range(30)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = build(chunk_len=1024, batch_size=8, compress="on")
        out = []
        th = threading.Thread(target=lambda: out.extend(t.scan_files(files)), daemon=True)
        th.start()
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive() and len(out) == len(files)
    for (path, data), secret in zip(files, out):
        assert secret.to_dict() == cpu.scan_bytes(path, data).to_dict(), path
    s = t.stats.snapshot()
    assert s["chunks"] == s["chunks_uploaded"] + s["chunks_dedup_hit"]
    assert s["chunks_dedup_hit"] > s["chunks_uploaded"]


# -- mirrors of tests/test_incremental.py's HitStore tests -------------------


def verdict(n=0):
    return (tuple(range(n)), (), True, None)


def test_store_byte_bound_and_entry_backstop():
    store = HitStore(b"fp" * 8, max_entries=10_000, max_bytes=2048)
    for i in range(200):
        store.put(i.to_bytes(16, "little"), verdict())
    assert store.bytes <= 2048 and store.entries < 200 and store.stats["evictions"] > 0
    assert store.get((199).to_bytes(16, "little")) is not None
    store = HitStore(b"fp" * 8, max_entries=8, max_bytes=1 << 30)
    for i in range(50):
        store.put(i.to_bytes(16, "little"), verdict())
    assert store.entries == 8


def test_store_batched_lookup_and_writeback():
    backend = new_cache("memory")
    calls = {"get": 0, "get_many": 0, "set_many": 0}
    get, get_many, set_many = backend.get_blob, backend.get_blobs, backend.set_blobs

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    backend.get_blob = count("get", get)
    backend.get_blobs = count("get_many", get_many)
    backend.set_blobs = count("set_many", set_many)
    a = HitStore(b"fp" * 8, backend=backend, write_batch=4)
    keys = [i.to_bytes(16, "little") for i in range(10)]
    for k in keys:
        a.put(k, verdict(2))
    a.flush_writes(force=True)
    assert calls["set_many"] >= 1
    b = HitStore(b"fp" * 8, backend=backend)
    assert len(b.lookup_batch(keys)) == 10
    assert calls["get_many"] == 1 and b.stats["warm_hits"] == 10
    assert calls["get"] <= 2  # only the namespace-marker reads


def test_store_export_and_seed_respect_the_namespace(caplog):
    a, b = HitStore(b"A" * 16), HitStore(b"B" * 16)
    a.put(b"k" * 16, verdict(1))
    export = a.export_warm()
    assert export and export[0][0].startswith(a.prefix)
    with caplog.at_level(logging.WARNING):
        assert b.seed(export) == 0
    assert "dropped" in caplog.text
    assert a.seed(export) == 1


def test_store_fingerprint_change_is_loud(tmp_path, caplog):
    backend = new_cache("fs", str(tmp_path / "store"))
    HitStore(b"A" * 16, backend=backend)
    with caplog.at_level(logging.WARNING):
        HitStore(b"B" * 16, backend=backend)
    assert "not seen before" in caplog.text and "COLD" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        HitStore(b"A" * 16, backend=backend)
        HitStore(b"B" * 16, backend=backend)
    assert "COLD" not in caplog.text


def warm_files():
    big = (b"int x;\n" * 300) + SAMPLES["slack-access-token"].encode() + b"\n" + (b"int y;\n" * 300)
    return [("a/big.c", big), ("a/tok.h", f"a\n{GHP}\nb\n".encode()),
            ("a/plain.h", b"// nothing here\n" * 30)]


def test_warm_rescan_served_from_backend(cpu):
    backend = new_cache("memory")
    files = warm_files()
    assert_parity(cpu, build(chunk_len=1024, batch_size=4, hit_cache=backend), files)
    b = build(chunk_len=1024, batch_size=4, hit_cache=backend)  # cold LRU, warm backend
    assert_parity(cpu, b, files)
    s = b.stats.snapshot()
    assert s["chunks_uploaded"] == 0 and s["batches"] == 0
    assert s["chunks_warm_hit"] == s["chunks"] > 0
    assert s["bytes_warm_hit"] == s["bytes_dedup_hit"] >= s["bytes_in"]


def test_changed_rule_file_never_serves_stale_findings(tmp_path):
    cfg = tmp_path / "rules.yaml"
    cfg.write_text("enable-builtin-rules: [github-pat]\n")
    backend = new_cache("fs", str(tmp_path / "store"))
    files = [("src/t.txt", b"x zzz_0123abcd y\n" + b"pad\n" * 40)]

    def scanner():
        return TorchSecretScanner(ScannerConfig.from_yaml_file(str(cfg)), chunk_len=1024,
                                  batch_size=4, device="cpu", hit_cache=backend)

    a = scanner()
    assert not list(a.scan_files(files))[0].findings
    cfg.write_text("enable-builtin-rules: [github-pat]\nrules:\n  - id: zzz-token\n"
                   "    regex: zzz_[0-9a-f]{8}\n    keywords: [zzz_]\n    severity: HIGH\n")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("trivy_tpu_torch.secret:hitstore")
    logger.addHandler(handler)
    try:
        b = scanner()
    finally:
        logger.removeHandler(handler)
    assert b.ruleset_fingerprint != a.ruleset_fingerprint
    assert any(f.rule_id == "zzz-token" for f in list(b.scan_files(files))[0].findings)
    assert b.stats.snapshot()["chunks_warm_hit"] == 0
    assert any("not seen before" in str(r.msg) for r in records)


def test_seeded_store_skips_uploads():
    files = warm_files()
    a = build(chunk_len=1024, batch_size=4)
    list(a.scan_files(files))
    export = a._hit_store.export_warm()
    b = build(chunk_len=1024, batch_size=4)
    assert export and b._hit_store.seed(export) == len(export)
    list(b.scan_files(files))
    s = b.stats.snapshot()
    assert s["chunks_uploaded"] == 0 and s["chunks_dedup_hit"] > 0


def test_dedup_mb_bounds_the_store():
    assert build(hit_cache_bytes=3 << 20)._hit_store.max_bytes == 3 << 20
    assert build()._hit_store.max_bytes == 32 << 20


# -- the fs command's feed flags ---------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    make_tree(root)
    (root / "vendor2").mkdir()
    (root / "vendor2" / "big.conf").write_bytes((root / "src" / "big.conf").read_bytes())
    # a text head keeps the binary sniff off; the zero body is several rows
    (root / "sparse.dat").write_bytes(b"header text\n" * 30 + b"\0" * 100_000 + b"end\n")
    return root


@pytest.fixture(scope="module")
def jax_results(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "jax.json"
    assert jax_cli.main(["fs", "--scanners", "secret", "--format", "json", "-o", str(out),
                         "-q", "--backend", "cpu", str(tree)]) == 0
    return json.loads(out.read_text())["Results"]


def run_port(tree, tmp_path, tag, *extra):
    out, stats = tmp_path / f"{tag}.json", tmp_path / f"{tag}.stats.json"
    assert cli.main(["fs", "--scanners", "secret", "--format", "json", "-o", str(out), "-q",
                     "--device", "cpu", "--stats-out", str(stats), *extra, str(tree)]) == 0
    return json.loads(out.read_text())["Results"], json.loads(stats.read_text())


@pytest.mark.parametrize("flags", [
    ["--secret-compress", "on"],
    ["--no-secret-dedup"],
    ["--no-secret-dedup", "--secret-compress", "on", "--secret-compress-min-ratio", "0.5"],
    ["--secret-compress", "on", "--no-secret-compress", "--secret-dedup-mb", "1"],
])
def test_fs_feed_flags_keep_results(tree, jax_results, tmp_path, flags):
    results, stats = run_port(tree, tmp_path, "port", *flags)
    assert results == jax_results
    assert stats["chunks"] > 0
    on = "on" in flags and "--no-secret-compress" not in flags
    assert (stats["batches_compressed"] + stats["batches_raw_fallback"] > 0) == on
    assert (stats["chunks_dedup_hit"] > 0) == ("--no-secret-dedup" not in flags or on)


@pytest.mark.parametrize("backend", ["fs", "memory"])
def test_fs_hit_cache_rescan(tree, jax_results, tmp_path, backend):
    flags = ["--secret-hit-cache", "--cache-dir", str(tmp_path / "cache"),
             "--cache-backend", backend, "--secret-compress", "on"]
    cold, cold_stats = run_port(tree, tmp_path, "cold", *flags)
    warm, warm_stats = run_port(tree, tmp_path, "warm", *flags)
    assert cold == warm == jax_results
    assert cold_stats["batches"] > 0
    if backend == "fs":  # a memory store lives as long as its process's command
        assert warm_stats["batches"] == 0 and warm_stats["chunks_warm_hit"] > 0
        assert list((tmp_path / "cache" / "fanal" / "blob").iterdir())
    else:
        assert warm_stats["batches"] > 0


def test_fs_rejects_an_unknown_cache_backend(tree):
    with pytest.raises(SystemExit):
        cli.main(["fs", "--device", "cpu", "--cache-backend", "redis://x", str(tree)])
    with pytest.raises(ValueError, match="unknown cache backend"):
        new_cache("redis://localhost:6379")
