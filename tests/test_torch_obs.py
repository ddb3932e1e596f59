"""The port's span layer (``trivy_tpu_torch/obs/``) against the JAX
package's ``trivy_tpu/obs/``: the same span durations, counters, samples,
profile entries, probe values and ledger events, made from a numpy seed,
go into a JAX ``TraceContext`` and the port's, and the stall verdict, the
metrics, profile and time-series documents (trace ids and wall times
masked), the Chrome trace's names, tracks and phases, the report, the
hottest-rules table and the registry's text exposition must be equal. The
license classifier and the CVE join, traced on the same inputs in both
packages, record the same span, counter and sample names."""

import gzip
import io
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest

from tests.test_torch_detector import build_apps, synthetic_apps, synthetic_db
from trivy_tpu import obs as jobs
from trivy_tpu.db import VulnDB as JaxVulnDB
from trivy_tpu.detector import library as jax_library
from trivy_tpu.licensing.classify import LicenseClassifier as JaxClassifier
from trivy_tpu.obs import export as jexport
from trivy_tpu.obs import metrics as jmetrics
from trivy_tpu.obs import profile as jprofile
from trivy_tpu.obs import recorder as jrecorder
from trivy_tpu.obs import stall as jstall
from trivy_tpu.obs import timeseries as jtimeseries
from trivy_tpu.parallel.mesh import DeviceBusyTracker as JaxBusy
from trivy_tpu.tuning import validate_interval as jax_validate_interval
from trivy_tpu.types import Application as JaxApplication
from trivy_tpu.types import Package as JaxPackage
from trivy_tpu_torch import obs as tobs
from trivy_tpu_torch.db import VulnDB
from trivy_tpu_torch.detector import library
from trivy_tpu_torch.licensing.classify import LicenseClassifier
from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
from trivy_tpu_torch.obs import export as texport
from trivy_tpu_torch.obs import metrics as tmetrics
from trivy_tpu_torch.obs import profile as tprofile
from trivy_tpu_torch.obs import recorder as trecorder
from trivy_tpu_torch.obs import stall as tstall
from trivy_tpu_torch.obs import timeseries as ttimeseries
from trivy_tpu_torch.types import Application, Package

# span names of every pipeline the port records (bucketed and not)
SPANS = ["secret.feed_wait", "secret.dispatch", "secret.decompress", "secret.prefilter",
         "secret.device_wait", "secret.compress", "secret.warm_hit", "secret.arena_wait",
         "secret.assemble", "license.dispatch", "license.device_wait", "license.finalize",
         "cve.join", "cve.dispatch", "driver.apply_layers", "driver.detect_vulns",
         "fs.read_wait", "fs.batch_analyze", "walk.next"]
RULES = ["aws-access-key-id", "github-pat", "slack-web-hook", "private-key", "jwt-token"]
PROBES = ["secret.arena_free_slabs", "secret.feed_queue_depth", "secret.bytes_uploaded_total",
          "device.d0.busy_seconds_total", "secret.files_pending"]


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def feed(seed: int):
    """Seeded calls for one context: ``(thread, kind, args)`` in order."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(300):
        name = SPANS[int(rng.integers(len(SPANS)))]
        # confirm spans come from three pool threads, like the confirm pool
        calls.append((0, "add", (name, float(rng.random()) * 0.2)))
    for t in (1, 2, 3):
        for _ in range(40):
            calls.append((t, "add", ("secret.confirm", float(rng.random()) * 0.05)))
    for name in ("secret.bytes_uploaded", "secret.bytes_packed", "license.score_rows",
                 "cve.resident_rows", "walk.files"):
        for _ in range(5):
            calls.append((0, "count", (name, int(rng.integers(1, 1 << 20)))))
    for _ in range(50):
        calls.append((0, "sample", ("secret.queue_depth", int(rng.integers(0, 3)))))
        calls.append((0, "sample", ("license.queue_depth", int(rng.integers(0, 2)))))
    for _ in range(60):
        rule = RULES[int(rng.integers(len(RULES)))]
        calls.append((0, "gate_hit", (rule, int(rng.integers(1, 4)))))
        calls.append((0, "prefilter_hit", (rule, int(rng.integers(1, 4)))))
        calls.append((0, "confirm", (rule, float(rng.random()) * 0.01, int(rng.integers(0, 2)))))
    for bucket in (256, 512, 1024, "license.gate:3x2048x1", "license.score:512x2048x1"):
        calls.append((0, "bucket", (bucket, int(rng.integers(1, 1024)), float(rng.random()))))
    calls.append((0, "prefilter_rows", (4096, 1024, 3000)))
    return calls


def replay(ctx, calls) -> None:
    """Apply ``calls`` to ``ctx`` (a JAX or a port context), pool-thread
    calls from real threads so the stall verdict sees their count."""
    by_thread: dict[int, list] = {}
    for t, kind, args in calls:
        by_thread.setdefault(t, []).append((kind, args))
    prof = ctx.profile()
    ops = {
        "add": ctx.add, "count": ctx.count, "sample": ctx.sample,
        "gate_hit": prof.gate_hit, "prefilter_hit": prof.prefilter_hit, "confirm": prof.confirm,
        "bucket": prof.bucket_dispatch, "prefilter_rows": prof.prefilter_rows,
    }

    def run(items):
        for kind, args in items:
            ops[kind](*args)

    run(by_thread.pop(0))
    # every pool thread stays alive to the end (distinct idents) and runs
    # its calls alone, in order (the same float sums in both replays)
    done = threading.Event()

    def pool_thread(go, ran, items):
        go.wait()
        run(items)
        ran.set()
        done.wait()

    threads = []
    for items in by_thread.values():
        go, ran = threading.Event(), threading.Event()
        th = threading.Thread(target=pool_thread, args=(go, ran, items))
        th.start()
        go.set()
        ran.wait()
        threads.append(th)
    done.set()
    for th in threads:
        th.join()


def sample_ticks(ctx, sampler_cls, seed: int):
    """Three sampler ticks over seeded probe values and progress, on a fake
    clock, then the sampler's stop (its final tick)."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    ctx.created = clock.t  # series times count from the context's creation
    ticks = [{p: float(rng.integers(0, 1 << 20)) * (i + 1) for p in PROBES} for i in range(4)]
    state = {"i": 0}
    ctx.add_probe(lambda: ticks[min(state["i"], 3)])
    prog = ctx.progress()
    prog.note_walked(1 << 20, files=10)
    s = sampler_cls(ctx, interval=0.25, clock=clock)
    for i in range(3):
        state["i"] = i
        clock.t += 0.25
        prog.note_scanned(1 << 18, files=2)
        s.sample_once()
    state["i"] = 3
    clock.t += 0.25
    s.stop()


@pytest.fixture
def fresh_recorder(monkeypatch):
    """The port's ledgers emptied for one test, and the process's restored
    after it (scans later in this process read them)."""
    monkeypatch.setattr(trecorder, "_STATE", trecorder._State())


@pytest.fixture
def contexts(fresh_recorder):
    """A JAX and a port context fed the same seeded calls, with both flight
    recorders reset and given the same compiles and residency events."""
    jrecorder.configure(True)
    calls = feed(7)
    cj = jobs.TraceContext("fs", enabled=True)
    ct = tobs.TraceContext("fs", enabled=True)
    replay(cj, calls)
    replay(ct, calls)
    for rec, activate, ctx in ((jrecorder, jobs.activate, cj), (trecorder, tobs.activate, ct)):
        with activate(ctx):
            rec.note_compile("match", "cached", 0.125)
            rec.note_compile("decompress", "nvcc", 2.5)
            rec.note_resident("arena", 5 << 24)
            rec.note_resident("corpus", 30803120)
            rec.release_resident("arena", 5 << 24)
    sample_ticks(cj, jtimeseries.Sampler, 3)
    sample_ticks(ct, ttimeseries.Sampler, 3)
    yield cj, ct
    jrecorder.configure(None)


WALL = {"trace_id", "elapsed_s", "mbs", "eta_s"}


def masked(doc):
    """``doc`` without trace ids and wall-clock-derived numbers."""
    if isinstance(doc, dict):
        return {k: ("*" if k in WALL else masked(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [masked(v) for v in doc]
    return doc


def test_stall_attribution_equal(contexts):
    cj, ct = contexts
    got = tstall.attribution(ct)
    assert got == jstall.attribution(cj)
    assert set(got) == {"cve", "license", "secret"}
    assert all(sum(p.values()) == 100 for p in got.values())
    assert tstall.verdict_lines(ct) == jstall.verdict_lines(cj)
    assert tstall.BUCKETS == jstall.BUCKETS and tstall.ORDER == jstall.ORDER


def test_metrics_dict_equal(contexts):
    cj, ct = contexts
    got, want = texport.metrics_dict(ct), jexport.metrics_dict(cj)
    assert masked(got) == masked(want)
    assert {"spans", "counters", "samples", "stall", "profile", "timeseries", "progress",
            "device"} <= set(got)
    assert got["device"]["compile_total"] == 2
    assert got["device"]["hbm"]["resident_bytes"] == {"arena": 0, "corpus": 30803120}


def test_profile_dict_equal(contexts):
    cj, ct = contexts
    assert masked(texport.profile_dict(ct)) == masked(jexport.profile_dict(cj))
    assert ct.profile().to_dict(top_k=2) == cj.profile().to_dict(top_k=2)


def test_timeseries_dict_equal(contexts):
    cj, ct = contexts
    got, want = texport.timeseries_dict(ct), jexport.timeseries_dict(cj)
    assert masked(got) == masked(want)
    assert {"secret.link_mbs", "device.d0.busy_ratio", "progress.ratio"} <= set(got["series"])
    assert ct.timeseries.to_doc(max_points=2) == cj.timeseries.to_doc(max_points=2)


def test_context_doc_equal(contexts):
    cj, ct = contexts
    got, want = texport.context_doc(ct), jexport.context_doc(cj)
    for name, s in got["spans"].items():
        assert tobs.wire_span_stats(s) == jobs.wire_span_stats(want["spans"][name]), name
    for doc in (got, want):
        for k in ("pid", "created_wall", "events"):
            doc.pop(k)
        for s in doc["spans"].values():
            s["values"] = sorted(s["values"])
    assert masked(got) == masked(want)


def _shape(events):
    """Each event's name, phase, process, category and track (a track by
    its label: track ids follow the order of span starts, which differs
    between two replays)."""
    label = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    return [(e["name"], e["ph"], e["pid"], e.get("cat"), label.get(e["tid"], e["tid"]))
            for e in events]


def test_chrome_trace_events_names_tracks_phases(contexts, tmp_path):
    cj, ct = contexts
    got, want = texport.chrome_trace_events(ct), jexport.chrome_trace_events(cj)
    assert sorted(_shape(got)) == sorted(_shape(want))
    tracks = {e["args"]["name"] for e in got if e["name"] == "thread_name"}
    assert {"secret.confirm", "secret.confirm #2", "secret.confirm #3"} <= tracks
    counters = {e["name"] for e in got if e["ph"] == "C"}
    assert {"secret.link_mbs", "device.compiles_total", "device.hbm_resident_bytes"} <= counters
    path = tmp_path / "t.json.gz"
    texport.write_chrome_trace(ct, str(path))
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert len(doc["traceEvents"]) == len(got)


def test_report_table_lines_and_registry_equal(contexts):
    cj, ct = contexts
    outj, outt = io.StringIO(), io.StringIO()
    cj.report(outj)
    ct.report(outt)
    assert outt.getvalue() == outj.getvalue()
    assert "-- stall attribution" in outt.getvalue()
    pj, pt = cj.merged_profile_dict(), ct.profile_doc()
    assert tprofile.table_lines(pt) == jprofile.table_lines(pj)
    assert tprofile.table_lines(pt, k=2) == jprofile.table_lines(pj, k=2)
    assert tprofile.top_rules(pt) == jprofile.top_rules(pj)
    rng = np.random.default_rng(5)
    regs = (jmetrics.Registry(), tmetrics.Registry())
    ops = [(int(rng.integers(3)), float(rng.random()) * 20, f"k{int(rng.integers(3))}")
           for _ in range(40)]
    for reg in regs:
        c = reg.counter("trivy_tpu_x_total", 'help with "quotes"\nand a newline',
                        labelnames=("kernel",))
        g = reg.gauge("trivy_tpu_hbm_bytes", "gauge", labelnames=("category",))
        h = reg.histogram("trivy_tpu_scan_seconds", "histogram")
        plain = reg.counter("trivy_tpu_plain_total")
        for kind, v, label in ops:
            if kind == 0:
                c.inc(v, kernel=label)
            elif kind == 1:
                g.set(v, category=label)
            else:
                h.observe(v)
        plain.inc(3)
        g.remove(category="k0")
        with pytest.raises(ValueError):
            reg.gauge("trivy_tpu_x_total")
        with pytest.raises(ValueError):
            reg.counter("trivy_tpu_x_total", labelnames=("other",))
    assert regs[1].render() == regs[0].render()


def test_device_doc_and_counter_series_equal(contexts):
    cj, ct = contexts
    assert trecorder.device_doc() == jrecorder.device_doc()
    sj, st = jrecorder.counter_series(cj), trecorder.counter_series(ct)
    assert {k: [v for _, v in d["points"]] for k, d in st.items()} == \
        {k: [v for _, v in d["points"]] for k, d in sj.items()}
    assert trecorder.hbm_ratio() == jrecorder.hbm_ratio()
    assert trecorder.live_fragment() == jrecorder.live_fragment()


def test_recorder_reports_no_storm(fresh_recorder):
    """A library loads once per process: the ``device`` block keeps the JAX
    storm keys, with no storm and the JAX package's threshold."""
    assert trecorder.device_doc() is None
    for _ in range(jrecorder.DEFAULT_STORM_THRESHOLD + 2):
        trecorder.note_compile("match", "cached", 0.5)
    doc = trecorder.device_doc()
    assert doc["recompile_storms"] == [] and doc["compile_total"] == 8
    assert doc["storm_threshold"] == jrecorder.DEFAULT_STORM_THRESHOLD
    assert trecorder.live_fragment() == "compiles 8"


def test_probe_values_sum_over_probes():
    """Secret runs of image layers scanned at once each register a probe:
    their series sum, and a probe registered twice counts once."""
    ct = tobs.TraceContext("image", enabled=True)

    def shared():
        return {"secret.bytes_uploaded_total": 100.0}

    ct.add_probe(shared)
    ct.add_probe(shared)
    for slabs in (3.0, 5.0):
        ct.add_probe(lambda slabs=slabs: {"secret.arena_slabs": slabs})
    ct.add_probe(lambda: 1 / 0)  # a probe that raises is skipped
    assert ct.probe_values() == {"secret.bytes_uploaded_total": 100.0,
                                 "secret.arena_slabs": 8.0}
    ct.remove_probe(shared)
    assert ct.probe_values() == {"secret.arena_slabs": 8.0}


def test_merge_wire_sums_runs():
    """The ``wire`` block sums every run's tallies; its ratio is that of
    the sums."""
    ct = tobs.TraceContext("image", enabled=True)
    runs = [{"bytes_compressed": 40, "bytes_raw_equiv": 100, "bytes_raw_fallback": 0,
             "batches_compressed": 1},
            {"bytes_compressed": 10, "bytes_raw_equiv": 100, "bytes_raw_fallback": 50,
             "batches_compressed": 1}]
    for w in runs:
        ct.merge_wire(w)
    assert ct.wire == {"compress": True, "compression_ratio": 100 / 250,
                       "bytes_compressed": 50, "bytes_raw_equiv": 200,
                       "bytes_raw_fallback": 50, "batches_compressed": 2}


def test_disabled_context_records_nothing():
    ct = tobs.TraceContext("fs")
    with ct.span("secret.dispatch"):
        pass
    ct.add("secret.confirm", 1.0)
    ct.count("secret.bytes_uploaded", 5)
    ct.sample("secret.queue_depth", 1)
    assert not ct.durations and not ct.counters and not ct.samples
    assert ct.span("x") is tobs._NULL
    ct.health_count("walk.skipped")  # the health channel is always on
    assert ct.health_snapshot() == {"walk.skipped": 1}
    ct.report(io.StringIO())  # prints nothing, raises nothing


def test_nested_spans_parent_per_thread():
    with tobs.scan_context("fs", enabled=True) as ct:
        with tobs.span("driver.detect_vulns") as outer:
            with tobs.span("cve.join") as inner:
                pass
        seen = []

        def worker():
            with tobs.activate(ct), tobs.span("secret.confirm") as sp:
                seen.append(sp)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert seen[0].parent_id is None and seen[0].thread != outer.thread
    assert tobs.current() is not ct and not tobs.current().enabled


def test_concurrent_recording_loses_nothing():
    """Sixteen threads record spans, counters, samples, profile entries and
    progress into one context at a short switch interval: every tally is
    exact."""
    ct = tobs.TraceContext("fs", enabled=True)
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with tobs.activate(ct):
            for _ in range(n):
                with tobs.span("secret.confirm"):
                    tobs.count("secret.bytes_uploaded", 2)
                tobs.sample("secret.queue_depth", 1)
                ct.profile().confirm("aws-access-key-id", 0.0, 1)
                ct.progress().note_scanned(3)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n
    assert ct.stage_stats()["secret.confirm"]["count"] == total == len(ct.events)
    assert ct.counters["secret.bytes_uploaded"] == 2 * total
    assert ct.samples["secret.queue_depth"][0] == total
    assert ct.profile_doc()["rules"]["aws-access-key-id"]["confirms"] == total
    assert ct.progress().snapshot()["bytes_scanned"] == 3 * total
    assert tstall.attribution(ct) == {"secret": {"confirm-bound": 100}}


@pytest.mark.parametrize("value", ["0", "0.25", "3", "-1", "nan", "inf", "x", None])
def test_validate_interval_equal(value):
    try:
        want = jax_validate_interval(value, "interval")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ttimeseries.validate_interval(value, "interval")
        assert str(got.value) == str(e)
    else:
        assert ttimeseries.validate_interval(value, "interval") == want


def test_default_interval_reads_the_environment(monkeypatch):
    monkeypatch.delenv("TRIVY_TPU_TELEMETRY_INTERVAL", raising=False)
    assert ttimeseries.default_interval() == jtimeseries.default_interval() == 0.25
    monkeypatch.setenv("TRIVY_TPU_TELEMETRY_INTERVAL", "0.5")
    assert ttimeseries.default_interval() == 0.5
    monkeypatch.setenv("TRIVY_TPU_TELEMETRY_INTERVAL", "-2")
    with pytest.raises(ValueError):
        ttimeseries.default_interval()


def test_sampler_thread_lifecycle():
    ct = tobs.TraceContext("fs", enabled=True)
    assert ttimeseries.start_sampler(ct, 0) is None and ct.timeseries is None
    s = ttimeseries.start_sampler(ct, 0.01)
    name = s._thread.name
    assert name.startswith("telemetry-sampler-")
    assert any(t.name == name for t in threading.enumerate())
    s.stop()
    assert not any(t.name == name for t in threading.enumerate())
    assert ct.timeseries.names() == []  # no probe, no progress: no series


def test_busy_tracker_equal():
    clocks = (FakeClock(), FakeClock())
    trackers = (JaxBusy(1, clock=clocks[0]), ttimeseries.DeviceBusyTracker(1, clock=clocks[1]))
    rng = np.random.default_rng(11)
    steps = [(int(rng.integers(3)), float(rng.random())) for _ in range(50)]
    for tr, clock in zip(trackers, clocks):
        for kind, dt in steps:
            clock.t += dt
            (tr.begin, tr.end, lambda _i: None)[kind](0)
    assert trackers[1].probe() == trackers[0].probe()


def test_ring_buffer_and_progress_equal():
    rings = (jtimeseries.RingBuffer(4), ttimeseries.RingBuffer(4))
    progs = (jtimeseries.ScanProgress(), ttimeseries.ScanProgress())
    for ring, prog in zip(rings, progs):
        for i in range(7):
            ring.append(float(i), float(i * i))
        prog.note_walked(1000, files=4)
        prog.note_scanned(999, files=4)
        prog.finish_walk()
    assert list(rings[1].points) == list(rings[0].points) and rings[1].dropped == 3
    assert progs[1].ratio() == progs[0].ratio() == 0.999
    for prog in progs:
        prog.finish()
    assert progs[1].ratio() == progs[0].ratio() == 1.0
    assert set(progs[1].snapshot()) == set(progs[0].snapshot())


def _names(ctx):
    return (set(ctx.stage_totals()), set(ctx.counters), set(ctx.samples))


def test_license_classifier_records_the_jax_names():
    """Eight license texts through both classifiers' device paths (the JAX
    one on XLA, the port's plain versions on the CPU): the same spans,
    counters, samples and profile buckets, and the same counts."""
    texts = [FULL_TEXTS[k] for k in sorted(FULL_TEXTS)[:8]]
    with jobs.scan_context("fs", enabled=True) as cj:
        want = JaxClassifier(backend="xla").classify_batch(texts)
    with tobs.scan_context("fs", enabled=True) as ct:
        got = LicenseClassifier(device="cpu").classify_batch(texts)
    assert [[f.name for f in r] for r in got] == [[f.name for f in r] for r in want]
    assert _names(ct) == _names(cj)
    assert {"license.dispatch", "license.device_wait", "license.finalize"} <= _names(ct)[0]
    assert ct.counters == cj.counters
    assert ({k: v["rows"] for k, v in ct.profile().to_dict()["buckets"].items()}
            == {k: v["rows"] for k, v in cj.profile().to_dict()["buckets"].items()})
    assert tstall.attribution(ct).keys() == jstall.attribution(cj).keys() == {"license"}


def test_cve_join_records_the_jax_names(tmp_path):
    """The resident CVE join on a synthetic DB, traced twice in both
    packages: the same spans and counters with the same values (the second
    scan uploads no bound bytes)."""
    path = synthetic_db(tmp_path)
    port_db, jax_db = VulnDB.load(path), JaxVulnDB.load(path)
    spec = synthetic_apps(300)
    for scan in range(2):
        with jobs.scan_context("sbom", enabled=True) as cj:
            jax_library.detect_batch(jax_db, build_apps(spec, JaxApplication, JaxPackage))
        stats = Counter()
        with tobs.scan_context("sbom", enabled=True) as ct:
            library.detect_batch(port_db, build_apps(spec, Application, Package), "cpu", stats)
        assert _names(ct) == _names(cj)
        assert _names(ct)[0] == {"cve.join", "cve.dispatch"}
        assert ct.counters == cj.counters
        assert ct.counters.get("cve.bounds_bytes_uploaded", 0) == (0 if scan else
                                                                   port_db._lib_resident.bounds.nbytes)
        assert stats["cve.join.seconds"] > 0 and stats["cve.resident_rows"] > 0
        assert tstall.attribution(ct) == jstall.attribution(cj) == {"cve": {"upload-bound": 100}}
