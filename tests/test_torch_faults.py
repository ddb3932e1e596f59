"""The port's fault-injection registry (``trivy_tpu_torch/faults.py``) held
against the JAX package's (``trivy_tpu/faults.py``): the spec grammar, the
Nth-hit and seeded-rate schedules and the error kinds, on the same specs
and hit sequences, with exact equality. Then the OOM shape of PyTorch's
allocator, and the port's deliberate differences: a kernel that cannot be
built, loaded or launched (``KernelError``), or whose CUDA error surfaces at
a fetch, fails the scan and is never retried or degraded, with or without
``--no-host-fallback``; and on ``cuda`` an exhausted ladder fails the scan
instead of finishing the card's work on the host."""

from __future__ import annotations

import dataclasses
import logging
from collections import Counter

import numpy as np
import pytest
import torch

from tests.secret_samples import SAMPLES
from trivy_tpu import faults as jfaults
from trivy_tpu.secret.tpu_scanner import _is_oom as jax_is_oom
from trivy_tpu_torch import cli, faults, obs
from trivy_tpu_torch.ops import _build
from trivy_tpu_torch.ops._build import KernelError
from trivy_tpu_torch.secret import scanner as tscanner
from trivy_tpu_torch.secret.engine import ScannerConfig
from trivy_tpu_torch.secret.scanner import TorchSecretScanner

GHP = "ghp_" + "A1b2C3d4E5f6G7h8I9j0K1l2M3n4O5p6Q7r8"


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


def rules(plan) -> list[dict]:
    return [dataclasses.asdict(r) for r in plan.rules]


SPECS = [
    "device.dispatch:at=3",
    "device.dispatch@d3:times=-1",
    "device.dispatch:at=1:error=oom",
    "cache.redis.get:times=-1",
    "rpc.post:rate=0.2:error=conn,seed=7",
    "site.a:at=3:times=2,site.b@k1:error=oom,seed=5",
    "cache.redis.get@fanal::artifact::abc:times=-1",
    "walker.read@a.txt:times=-1:error=io",
    " a.b:error=conn , c.d:error=io ,",
    "device.dispatch@license:at=2:times=-1,device.dispatch@cve:times=-1",
    "",
    # bad specs: both packages raise ValueError
    "x:wat=1", "x:error=nope", "x:at=0", "x:nonsense", "x:at=two", "seed=x",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_jax(spec):
    try:
        want = jfaults.parse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            faults.parse(spec)
        return
    got = faults.parse(spec)
    assert rules(got) == rules(want) and got.seed == want.seed


def hits(mod, spec: str, calls: list[tuple]) -> list[str]:
    """Arm ``spec`` in ``mod`` and make ``calls`` (site, key): what each
    raised (its type's name and message) or ``-``."""
    mod.configure(spec)
    out = []
    for site, key in calls:
        try:
            mod.check(site, key=key)
            out.append("-")
        except Exception as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


SCHEDULES = [
    ("site.a:at=3:times=2,site.b@k1:error=oom,seed=5",
     [("site.a", None)] * 6 + [("site.b", "k2"), ("site.b", "k1")]),
    ("a.b:error=conn,c.d:error=io", [("a.b", None), ("c.d", None)]),
    ("s@ka:at=2:times=-1", [("s", "kb"), ("s", "kb"), ("s", "ka")] + [("s", "ka")] * 5),
    ("cache.redis.get@fanal::artifact::abc:times=-1",
     [("cache.redis.get", "fanal::artifact::other"), ("cache.redis.get", "fanal::artifact::abc")]),
    ("s.r:rate=0.5,seed=7", [("s.r", "k")] * 64),
    ("s.r:rate=0.5,seed=8", [("s.r", "k")] * 64),
    ("device.dispatch:times=-1", [("device.dispatch", "d0")] * 3 + [("device.fetch", "d0")]),
]


@pytest.mark.parametrize("spec,calls", SCHEDULES, ids=[s for s, _ in SCHEDULES])
def test_schedule_equals_jax(spec, calls):
    """test_faults.py's registry tests (nth hit, error kinds, forever and
    per-key counters, seeded rate, keys holding ':'), on both packages."""
    want = hits(jfaults, spec, calls)
    got = hits(faults, spec, calls)
    assert got == want
    assert faults.plan().fired() == jfaults.plan().fired()


def test_spec_parsing_and_nth_hit():
    plan = faults.configure("site.a:at=3:times=2,site.b@k1:error=oom,seed=5")
    assert plan.seed == 5
    fired = []
    for _ in range(6):
        try:
            faults.check("site.a")
            fired.append(False)
        except faults.InjectedFault:
            fired.append(True)
    assert fired == [False, False, True, True, False, False]
    faults.check("site.b", key="k2")
    with pytest.raises(faults.InjectedOom, match="RESOURCE_EXHAUSTED"):
        faults.check("site.b", key="k1")
    assert plan.fired() == {"site.a": 2, "site.b@k1": 1}


def test_error_kinds_are_the_jax_kinds():
    faults.configure("a.b:error=conn,c.d:error=io,e.f:error=oom,g.h")
    for site, kind in (("a.b", ConnectionError), ("c.d", OSError),
                       ("e.f", RuntimeError), ("g.h", RuntimeError)):
        with pytest.raises(kind):
            faults.check(site)
    assert {k: type(v("m")).__mro__[1] for k, v in faults._ERROR_KINDS.items()} == {
        k: type(v("m")).__mro__[1] for k, v in jfaults._ERROR_KINDS.items()}


def test_env_arming_and_disarmed(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "x.y:at=2")
    assert faults.ENV_VAR == jfaults.ENV_VAR
    plan = faults.configure_from_env()
    assert plan.rules[0].site == "x.y" and plan.rules[0].at == 2 and faults.active()
    faults.clear()
    assert not faults.active() and faults.plan() is None
    faults.check("device.dispatch", key="d0")  # no plan: never raises


def test_injected_fault_lands_in_the_flight_ring():
    from trivy_tpu_torch.obs import recorder

    with obs.scan_context(name="ring") as ctx:
        faults.configure("device.dispatch@d0")
        with pytest.raises(faults.InjectedFault):
            faults.check("device.dispatch", key="d0")
        ev = recorder._ctx_ring(ctx).snapshot()[-1]
    assert (ev["kind"], ev["what"], ev["detail"]) == (
        "fault", "device.dispatch@d0", {"error": "InjectedFault"})


# -- the OOM shape ------------------------------------------------------------


@pytest.mark.parametrize("err", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 16.00 MiB. GPU 0 has a "
                           "total capacity of 79.19 GiB of which 3.06 MiB is free."),
    RuntimeError("CUDA error: out of memory"),
    faults.InjectedOom("RESOURCE_EXHAUSTED: out of memory: injected fault"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    faults.InjectedFault("injected fault at device.dispatch[d0] hit 1"),
    KernelError("match kernel launch failed: invalid argument (1)"),
], ids=["torch-oom", "cuda-oom", "injected-oom", "illegal-address", "fault", "kernel"])
def test_is_oom_is_the_jax_test(err):
    """PyTorch's allocator error is OOM-shaped under the JAX package's
    markers; an illegal address or a refused launch is not."""
    assert tscanner._is_oom(err) == jax_is_oom(err)
    assert tscanner._is_oom(err) == ("out of memory" in str(err))


# -- step 0: a kernel that cannot build, load or launch fails loudly ---------


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA reported present and every kernel library failing to build: the
    construction of any stage on ``cuda`` must raise before touching a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def no_nvcc(name):
        raise KernelError(f"nvcc failed for {name}.cu: (injected)")

    monkeypatch.setattr(_build, "load", no_nvcc)


CFG = ScannerConfig.from_dict({"enable-builtin-rules": ["github-pat"]})


def test_kernel_build_failure_fails_scanner_construction(fake_card):
    with pytest.raises(KernelError, match="match.cu"):
        TorchSecretScanner(CFG, device="cuda")
    with pytest.raises(KernelError, match="match.cu"):
        TorchSecretScanner(CFG, device="cuda", host_fallback=False)


def test_kernel_build_failure_fails_classifier_and_join(fake_card):
    from trivy_tpu_torch.licensing.classify import LicenseClassifier

    with pytest.raises(KernelError, match="bytes_gate.cu"):
        LicenseClassifier(device="cuda")
    with pytest.raises(KernelError, match="verscmp.cu"):
        _build.preload("verscmp")


@pytest.mark.parametrize("fallback", [[], ["--no-host-fallback"]], ids=["fallback", "no-fallback"])
def test_device_backend_init_failure_fails_loudly(fake_card, tmp_path, fallback):
    """The deliberate difference from the JAX package, whose backend failing
    at init degrades to the host engine
    (test_faults.py::test_device_backend_init_failure_degrades_to_host): in
    the port the scan fails, naming the kernel, whatever the flag says."""
    (tmp_path / "gh.txt").write_text(f"token {GHP} end\n")
    out = tmp_path / "out.json"
    with obs.scan_context(name="init") as ctx:
        with pytest.raises(KernelError, match="match.cu"):
            cli.main(["fs", "--scanners", "secret", "--device", "cuda", "--format", "json",
                      "-o", str(out), "--cache-dir", str(tmp_path / "c"), *fallback,
                      str(tmp_path)])
        assert not ctx.health_snapshot().get("scan.degraded")
    assert not out.exists()


def corpus(n: int = 24) -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(5)
    return [(f"f{i}.txt", b"x = 1\n" + SAMPLES["github-pat"].encode() + b"\n"
             + rng.integers(97, 123, size=3000, dtype=np.uint8).tobytes()) for i in range(n)]


# kernel faults: a launch the wrapper refused, and CUDA errors that surface
# at the fetch waiting on a kernel (PyTorch raises an illegal address or a
# failed launch there as AcceleratorError, a RuntimeError)
KERNEL_FAULTS = [
    KernelError("match kernel launch failed: too many resources requested (7)"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
]
FAULT_IDS = ["refused", "accelerator", "cuda-error"]


@pytest.mark.parametrize("err,fault", [
    *((e, True) for e in KERNEL_FAULTS),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 16.00 MiB"), False),
    (torch.AcceleratorError("CUDA error: out of memory"), False),
    (faults.InjectedFault("injected fault at device.dispatch[d0] hit 1"), False),
    (RuntimeError("copy failed"), False),
], ids=[*FAULT_IDS, "torch-oom", "cuda-oom", "injected", "other"])
def test_kernel_fault_classification(err, fault):
    assert _build.kernel_fault(err) is fault


@pytest.mark.parametrize("err", KERNEL_FAULTS, ids=FAULT_IDS)
@pytest.mark.parametrize("host_fallback", [True, False], ids=["fallback", "no-fallback"])
def test_kernel_launch_failure_is_never_retried_or_degraded(monkeypatch, host_fallback, err):
    """A kernel fault raised where ``run_batch`` launches or fetches fails
    the scan at once, whatever ``host_fallback`` says."""
    sc = TorchSecretScanner(CFG, chunk_len=1024, batch_size=8, device="cpu",
                            host_fallback=host_fallback)

    def refused(rows, n_live):
        raise err

    monkeypatch.setattr(sc, "run_batch", refused)
    with obs.scan_context(name="fault") as ctx:
        with pytest.raises(type(err), match=str(err)[:20]):
            list(sc.scan_files(corpus()))
        assert not ctx.health_snapshot().get("scan.degraded")
    s = sc.stats.snapshot()
    assert s["batch_retries"] == s["batch_splits"] == s["degraded"] == 0


@pytest.mark.parametrize("err", KERNEL_FAULTS, ids=FAULT_IDS)
@pytest.mark.parametrize("host_fallback", [True, False], ids=["fallback", "no-fallback"])
def test_kernel_launch_failure_in_classifier_and_join_is_raised(monkeypatch, tmp_path,
                                                                host_fallback, err):
    from tests.test_torch_detector import build_apps, fixture_apps
    from tests.dbtest import build_db
    from trivy_tpu_torch.db import VulnDB
    from trivy_tpu_torch.detector import library
    from trivy_tpu_torch.licensing.classify import LicenseClassifier
    from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
    from trivy_tpu_torch.ops import verscmp
    from trivy_tpu_torch.types import Application, Package

    clf = LicenseClassifier(device="cpu", host_fallback=host_fallback)
    scorer = clf._device_scorer()

    def refused(*a, **k):
        raise err

    monkeypatch.setattr(scorer, "gate_bytes", refused)
    with obs.scan_context(name="fault") as ctx:
        with pytest.raises(type(err)):
            clf.classify_batch([FULL_TEXTS["MIT"]] * 8)
        monkeypatch.setattr(verscmp, "check_ops_gather_bucketed", refused)
        db = VulnDB.load(build_db(tmp_path))
        stats = Counter()
        with pytest.raises(type(err)):
            library.detect_batch(db, build_apps(fixture_apps(700), Application, Package), "cpu",
                                 stats, host_fallback=host_fallback)
        assert not stats["cve.degraded"]
        assert not ctx.health_snapshot()


# -- on cuda an exhausted ladder fails the scan --------------------------------


@pytest.fixture
def card_device(monkeypatch):
    """CUDA reported present with every kernel library loading: a stage
    built on the CPU and then pointed at ``cuda`` walks the ladder as on the
    card, while its kernels still run their plain versions here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(_build, "preload", lambda *names: None)
    return torch.device("cuda", 0)


def test_degrade_or_raise_takes_the_host_only_on_the_cpu(card_device):
    err = faults.InjectedFault("injected fault at device.dispatch[d0] hit 3")
    log = logging.getLogger("policy")
    with obs.scan_context(name="policy") as ctx:
        for device, fallback in ((card_device, True), (card_device, False),
                                 (torch.device("cpu"), False)):
            with pytest.raises(faults.InjectedFault):
                obs.degrade_or_raise(err, device=device, host_fallback=fallback,
                                     counter="x.degraded", logger=log, message="%s")
        assert not ctx.health_snapshot()
        obs.degrade_or_raise(err, device=torch.device("cpu"), host_fallback=True,
                             counter="x.degraded", logger=log, message="%s")
        assert ctx.health_snapshot() == {"x.degraded": 1, "scan.degraded": 1}


@pytest.mark.parametrize("host_fallback", [True, False], ids=["fallback", "no-fallback"])
def test_exhausted_ladder_on_cuda_fails_the_scan(card_device, monkeypatch, host_fallback):
    """Every dispatch dead on ``cuda``: the batch is retried on the card
    ``BATCH_RETRIES`` times, then the scan fails with the fault instead of
    finishing on the host, whatever ``host_fallback`` says."""
    sc = TorchSecretScanner(CFG, chunk_len=1024, batch_size=8, device="cpu",
                            host_fallback=host_fallback)
    monkeypatch.setattr(sc, "_alloc_slab", lambda rows, row_len: np.zeros((rows, row_len),
                                                                          dtype=np.uint8))
    sc.device = card_device
    faults.configure("device.dispatch:times=-1")
    with obs.scan_context(name="dead") as ctx:
        with pytest.raises(faults.InjectedFault, match="hit 3"):
            list(sc.scan_files(corpus()))
        assert not ctx.health_snapshot().get("scan.degraded")
    s = sc.stats.snapshot()
    assert (s["batch_retries"], s["batch_splits"], s["degraded"]) == (tscanner.BATCH_RETRIES, 0, 0)


def test_classifier_and_join_on_cuda_fail_instead_of_degrading(card_device, monkeypatch,
                                                              tmp_path):
    from tests.test_torch_detector import build_apps, fixture_apps
    from tests.dbtest import build_db
    from trivy_tpu_torch.db import VulnDB
    from trivy_tpu_torch.detector import library
    from trivy_tpu_torch.licensing.classify import LicenseClassifier
    from trivy_tpu_torch.licensing.corpus_texts import FULL_TEXTS
    from trivy_tpu_torch.types import Application, Package

    clf = LicenseClassifier(device="cpu")
    clf._device_scorer()
    clf.device = card_device
    faults.configure("device.dispatch@license:times=-1,device.dispatch@cve:times=-1")
    with obs.scan_context(name="dead") as ctx:
        with pytest.raises(faults.InjectedFault, match="license"):
            clf.classify_batch([FULL_TEXTS["MIT"]] * 8)
        monkeypatch.setattr(library, "_resident_verdicts", lambda *a, **k: faults.check(
            "device.dispatch", key="cve"))
        db = VulnDB.load(build_db(tmp_path))
        stats = Counter()
        with pytest.raises(faults.InjectedFault, match="cve"):
            library.detect_batch(db, build_apps(fixture_apps(700), Application, Package),
                                 "cuda", stats)
        assert not stats["cve.degraded"]
        assert not ctx.health_snapshot()
