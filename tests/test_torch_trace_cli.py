"""``--trace``, ``--trace-out``, ``--metrics-out``, ``--profile-out``,
``--timeseries-out``, ``--telemetry-interval`` and ``--live`` on the port's
CLI against the JAX CLI (``fs --backend xla``), both run in-process from
one fresh working directory on one small tree: two planted secrets, eight
license texts, an alpine package DB and a lockfile, with the DB of
``tests/dbtest.py``. The documents must carry the same keys, span, counter
and sample names, Chrome-trace tracks and stall pipelines, apart from the
exceptions listed below with their reasons; findings must not change with
tracing on; an untraced scan starts no sampler thread and writes no file."""

import gzip
import json
import os
import re
import threading
from pathlib import Path

import pytest

from tests.dbtest import build_db
from tests.imagetest import docker_save_tar, tar_bytes
from tests.secret_samples import SAMPLES
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.licensing import classify as jax_classify
from trivy_tpu_torch import cli
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS

# keys of the JAX documents the port's lack, and why
JAX_ONLY_KEYS = {
    # the JAX commands register their resolved TuningConfig on every scan;
    # the tuning config and autotune are not ported (ROADMAP Queue A item 5)
    "tuning": "TuningConfig is not ported",
}
# time series of the JAX feed the port's lack, and why: the JAX feed runs
# a tunable number of transfer streams (one ``secret.stream<N>.inflight``
# series each) and in-flight batches per stream (TuningConfig); the port
# runs one transfer stream, one batch at a time
JAX_ONLY_SERIES = re.compile(
    r"secret\.(active_streams|inflight_window|stream\d+\.inflight)$")
# span, counter and sample names one side records and the other does not:
# none on this tree (mesh.* spans and secret.host_fallback need a device
# mesh and the host fallback, neither of which an fs scan here reaches;
# the port ports neither, ROADMAP Queue A items 5 and 6)
PORT_ONLY_NAMES: dict[str, str] = {}
JAX_ONLY_NAMES: dict[str, str] = {}

EXPORTS = ("--trace-out", "trace.json", "--metrics-out", "metrics.json",
           "--profile-out", "profile.json", "--timeseries-out", "timeseries.json")


def make_tree(root: Path) -> None:
    files = {
        "src/a.py": f"key = '{SAMPLES['github-pat']}'\n",
        "lib/b.env": f"AWS={SAMPLES['aws-access-key-id']}\n",
        "etc/alpine-release": "3.18.4\n",
        "lib/apk/db/installed": "P:musl\nV:1.2.3-r0\nL:MIT\n\nP:busybox\nV:1.36.0-r0\n"
                                "L:GPL-2.0-only\n",
        "web/package-lock.json": json.dumps({"lockfileVersion": 3, "packages": {
            "node_modules/lodash": {"version": "4.17.15"}}}),
    }
    # eight license files: the classifier's device path starts at eight texts
    for i, lic in enumerate(sorted(FULL_TEXTS)[:8]):
        files[f"deps/p{i}/LICENSE"] = FULL_TEXTS[lic]
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)


def head(e) -> list[str]:
    return ["fs", "--scanners", "vuln,secret,license", "--db-repository", e["db"],
            "--format", "json", "-q"]


def port(e, wd: Path, *extra, out="port.json") -> int:
    return cli.main([*head(e), "--device", "cpu", "-o", str(wd / out),
                     "--cache-dir", str(wd / "c1"), *extra, str(e["tree"])])


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("trace")
    make_tree(base / "tree")
    return {"tree": base / "tree", "db": build_db(base)}


@pytest.fixture(scope="module")
def runs(env, tmp_path_factory):
    """Both CLIs traced with all four exports, and the port untraced, from
    one fresh working directory. The JAX license classifier takes its device
    path only on an accelerator; here it is told to take it as on one, so
    both packages run the license pipeline on the eight texts."""
    wd = tmp_path_factory.mktemp("wd")
    cwd = os.getcwd()
    mp = pytest.MonkeyPatch()
    os.chdir(wd)
    try:
        mp.setattr(jax_classify.LicenseClassifier, "_use_device",
                   lambda self, n: n >= jax_classify.DEVICE_MIN_TEXTS)
        (wd / "port").mkdir()
        (wd / "jax").mkdir()
        rc_port = port(env, wd, *[f"port/{a}" if a.endswith(".json") else a for a in EXPORTS])
        rc_jax = jax_cli.main([*head(env), "--backend", "xla", "-o", str(wd / "jax.json"),
                               "--cache-dir", str(wd / "c2"),
                               *[f"jax/{a}" if a.endswith(".json") else a for a in EXPORTS],
                               str(env["tree"])])
        rc_plain = port(env, wd, out="plain.json")
    finally:
        mp.undo()
        os.chdir(cwd)
    assert rc_port == rc_jax == rc_plain == 0

    def load(side):
        return {name: json.loads((wd / side / f"{name}.json").read_text())
                for name in ("trace", "metrics", "profile", "timeseries")}

    return {"wd": wd, "port": load("port"), "jax": load("jax"),
            "results": {k: json.loads((wd / f"{k}.json").read_text())["Results"]
                        for k in ("port", "jax", "plain")}}


def _tracks(trace: dict) -> set[str]:
    return {re.sub(r" #\d+$", "", e["args"]["name"]) for e in trace["traceEvents"]
            if e["name"] == "thread_name"}


def test_documents_have_the_jax_keys(runs):
    for name in ("trace", "metrics", "profile", "timeseries"):
        mine, ref = runs["port"][name], runs["jax"][name]
        assert set(mine) == set(ref) - set(JAX_ONLY_KEYS), name
    m, j = runs["port"]["metrics"], runs["jax"]["metrics"]
    for block in ("device", "progress", "profile"):
        assert set(m[block]) == set(j[block]), block
    assert set(m["device"]["hbm"]) == set(j["device"]["hbm"])
    # the ledger is the process's: earlier scans in this process may add to it
    assert {"arena", "corpus"} <= set(m["device"]["hbm"]["resident_bytes"])
    assert set(runs["port"]["trace"]["otherData"]) == set(runs["jax"]["trace"]["otherData"])
    assert m["progress"]["done"] and m["progress"]["ratio"] == 1.0


def test_span_counter_and_sample_names_equal(runs):
    m, j = runs["port"]["metrics"], runs["jax"]["metrics"]
    for key in ("spans", "counters", "samples"):
        assert set(m[key]) - set(PORT_ONLY_NAMES) == set(j[key]) - set(JAX_ONLY_NAMES), key
    assert {"secret.feed_wait", "secret.dispatch", "secret.prefilter", "secret.confirm",
            "secret.assemble", "license.dispatch", "license.device_wait", "license.finalize",
            "driver.apply_layers", "driver.detect_vulns", "fs.read_wait",
            "fs.batch_analyze", "walk.next"} <= set(m["spans"])
    assert {"secret.bytes_uploaded", "license.bytes_uploaded", "license.score_rows",
            "walk.files"} <= set(m["counters"])
    assert m["counters"]["license.score_rows"] == j["counters"]["license.score_rows"]
    assert m["counters"]["walk.files"] == j["counters"]["walk.files"]
    assert _tracks(runs["port"]["trace"]) == _tracks(runs["jax"]["trace"])
    series = set(runs["port"]["timeseries"]["series"])
    assert series == {n for n in runs["jax"]["timeseries"]["series"]
                      if not JAX_ONLY_SERIES.match(n)}
    assert {"secret.link_mbs", "device.d0.busy_ratio", "progress.ratio"} <= series
    phases = {e["ph"] for e in runs["port"]["trace"]["traceEvents"]}
    assert phases == {e["ph"] for e in runs["jax"]["trace"]["traceEvents"]} == {"M", "X", "C"}


def test_stall_pipelines_and_profile_equal(runs):
    m, j = runs["port"]["metrics"], runs["jax"]["metrics"]
    assert set(m["stall"]) == set(j["stall"]) == {"secret", "license"}
    p, q = runs["port"]["profile"], runs["jax"]["profile"]
    assert p["stall"] == m["stall"] and set(p["stage_total_ms"]) == set(m["spans"])
    # the same rules flagged and confirmed, with the same findings
    for rid, r in q["profile"]["rules"].items():
        assert p["profile"]["rules"][rid]["findings"] == r["findings"], rid
    assert {k.split(":")[0] for k in p["profile"]["buckets"] if ":" in k} == \
        {k.split(":")[0] for k in q["profile"]["buckets"] if ":" in k} == \
        {"license.gate", "license.score"}


def test_results_unchanged_by_tracing(runs):
    r = runs["results"]
    assert r["port"] == r["plain"] == r["jax"]
    assert any(x.get("Secrets") for x in r["port"]) and any(x.get("Licenses") for x in r["port"])


def test_untraced_scan_starts_no_sampler_and_writes_no_file(env, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    started = []
    real = threading.Thread.start

    def start(self):
        started.append(self.name)
        return real(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    assert port(env, tmp_path) == 0
    assert started and not [n for n in started if n.startswith("telemetry")]
    assert sorted(set(os.listdir(tmp_path)) - {"c1"}) == ["port.json"]


def test_trace_prints_the_span_table(env, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert port(env, tmp_path, "--trace") == 0
    err = capsys.readouterr().err
    for part in ("-- trace ", "secret.confirm", "-- stall attribution", "secret: ",
                 "-- hottest rules"):
        assert part in err, part
    assert sorted(set(os.listdir(tmp_path)) - {"c1"}) == ["port.json"]


def test_gzip_live_and_interval(env, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert port(env, tmp_path, "--live", "--timeseries-out", "ts.json.gz",
                "--metrics-out", "m.json.gz", "--telemetry-interval", "0.05") == 0
    with gzip.open(tmp_path / "ts.json.gz", "rt") as f:
        ts = json.load(f)
    with gzip.open(tmp_path / "m.json.gz", "rt") as f:
        assert "timeseries" in json.load(f)
    assert ts["progress"]["done"] and len(ts["series"]["progress.ratio"]["points"]) >= 2
    assert "scan " in capsys.readouterr().err
    # 0 turns the sampler off: the file holds no series
    assert port(env, tmp_path, "--timeseries-out", "off.json", "--telemetry-interval", "0") == 0
    assert json.loads((tmp_path / "off.json").read_text())["series"] == {}


@pytest.mark.parametrize("how", ["flag", "env"])
def test_bad_interval_is_a_usage_error(env, tmp_path, monkeypatch, how):
    monkeypatch.chdir(tmp_path)
    extra = ()
    if how == "flag":
        extra = ("--telemetry-interval", "-1")
    else:
        monkeypatch.setenv("TRIVY_TPU_TELEMETRY_INTERVAL", "nan")
    with pytest.raises(SystemExit) as exc:
        port(env, tmp_path, *extra)
    assert exc.value.code == 2


@pytest.mark.parametrize("how", ["env", "config"])
def test_trace_settings_resolve_from_env_and_config(env, tmp_path, monkeypatch, how):
    """``TRIVY_TPU_TRACE_OUT`` and ``trace.out`` / ``trace.metrics-out`` in
    ``trivy-tpu.yaml`` are ported settings, resolved as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    if how == "env":
        monkeypatch.setenv("TRIVY_TPU_TRACE_OUT", "t.json")
        monkeypatch.setenv("TRIVY_TPU_METRICS_OUT", "m.json")
    else:
        (tmp_path / "trivy-tpu.yaml").write_text(
            "trace:\n  out: t.json\n  metrics-out: m.json\n")
    assert port(env, tmp_path) == 0
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert "secret" in json.loads((tmp_path / "m.json").read_text())["stall"]


def test_sbom_documents_match_jax(env, tmp_path, monkeypatch):
    bom = {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": [
        {"type": "library", "name": "lodash", "version": "4.17.15",
         "purl": "pkg:npm/lodash@4.17.15"}]}
    (tmp_path / "bom.json").write_text(json.dumps(bom))
    monkeypatch.chdir(tmp_path)
    common = ["sbom", "--db-repository", env["db"], "--format", "json", "-q"]
    assert cli.main([*common, "--device", "cpu", "-o", "p.json", "--cache-dir", "c1",
                     "--metrics-out", "pm.json", "bom.json"]) == 0
    assert jax_cli.main([*common, "-o", "j.json", "--cache-dir", "c2",
                         "--metrics-out", "jm.json", "bom.json"]) == 0
    m, j = (json.loads((tmp_path / f).read_text()) for f in ("pm.json", "jm.json"))
    assert set(m) == set(j) - set(JAX_ONLY_KEYS)
    assert set(m["spans"]) == set(j["spans"]) == {"driver.apply_layers", "driver.detect_vulns"}
    assert m["progress"] == {**m["progress"], "files_walked": 1, "files_scanned": 1}
    assert json.loads((tmp_path / "p.json").read_text())["Results"] == \
        json.loads((tmp_path / "j.json").read_text())["Results"]


def test_parallel_image_layers_trace_into_one_context(env, tmp_path, monkeypatch):
    """Two layers analyzed at once over one secret scanner: both feeds'
    spans land in the command's one trace context."""
    layers = [tar_bytes({f"app{i}/creds.env": f"AWS={SAMPLES['aws-access-key-id']}\n".encode(),
                         f"app{i}/main.py": b"print('hi')\n"}) for i in range(2)]
    image = docker_save_tar(tmp_path / "img.tar", layers)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["image", "--scanners", "secret", "--device", "cpu", "--format", "json",
                     "-q", "-o", "p.json", "--cache-dir", "c1", "--parallel", "2",
                     "--metrics-out", "m.json", "--trace-out", "t.json", image]) == 0
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["spans"]["fs.batch_analyze"]["count"] == 2
    assert m["spans"]["secret.feed_wait"]["count"] >= 2
    assert set(m["stall"]) == {"secret"}
    trace = json.loads((tmp_path / "t.json").read_text())
    feeds = {e["tid"] for e in trace["traceEvents"] if e.get("name") == "secret.feed_wait"}
    assert len(feeds) == 2  # one device worker per layer's feed
    secrets = [r for r in json.loads((tmp_path / "p.json").read_text())["Results"]
               if r.get("Secrets")]
    assert len(secrets) == 2


# the wire block's fields, all tallies of the scanner's ScanStats
WIRE_FIELDS = ("bytes_compressed", "bytes_raw_equiv", "bytes_raw_fallback", "bytes_gated",
               "bytes_gated_binary", "chunks_gated_zero", "batches_compressed",
               "batches_raw_fallback")


@pytest.mark.parametrize("parallel", ["1", "2"])
def test_image_wire_is_the_sum_of_its_layers(env, tmp_path, monkeypatch, parallel):
    """Each layer is its own secret scan run over one scanner: the ``wire``
    block and the byte counters of ``--metrics-out`` must sum every layer's,
    the layers scanned one after another or at once, and so equal the
    scanner's totals in ``--stats-out``."""
    layers = [tar_bytes({f"app{i}/creds.env": f"AWS={SAMPLES['aws-access-key-id']}\n".encode(),
                         f"app{i}/main.py": b"print('hi')\n" * (200 + 50 * i)})
              for i in range(2)]
    image = docker_save_tar(tmp_path / "img.tar", layers)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["image", "--scanners", "secret", "--device", "cpu", "--format", "json",
                     "-q", "-o", "p.json", "--cache-dir", "c1", "--parallel", parallel,
                     "--secret-compress", "on", "--stats-out", "s.json",
                     "--metrics-out", "m.json", image]) == 0
    m = json.loads((tmp_path / "m.json").read_text())
    stats = json.loads((tmp_path / "s.json").read_text())
    assert stats["layers_analyzed"] == 2 and m["spans"]["fs.batch_analyze"]["count"] == 2
    wire = m["wire"]
    assert {k: wire[k] for k in WIRE_FIELDS} == {k: stats[k] for k in WIRE_FIELDS}
    assert wire["batches_compressed"] + wire["batches_raw_fallback"] >= 2
    raw = stats["bytes_raw_equiv"] + stats["bytes_raw_fallback"]
    assert wire["compression_ratio"] == \
        (stats["bytes_compressed"] + stats["bytes_raw_fallback"]) / raw
    assert m["counters"]["secret.bytes_uploaded"] == stats["bytes_uploaded"] > 0
