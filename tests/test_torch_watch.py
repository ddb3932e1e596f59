"""The port's ``watch`` command against the JAX package's
(``trivy_tpu/commands.py::_run_watch``): each tick is a ``--since-last``
incremental scan, a report is written after the first scan and after a
scan that re-analyzed a unit or changed the set of unit keys, ``--timeout``
arms no alarm, Ctrl-C ends the loop with the last exit code, and the JAX
flags the port lacks exit 2.

No test waits on a clock: the port's pause between scans is
``cli._pause``, patched here; the JAX watch sleeps through ``time.sleep``,
patched as the JAX package's own watch test patches it, for the JAX run
only and only for the watch loop's own pause (the JAX scan's threads share
the name). Both CLIs run on the CPU on copies of one seeded tree."""

import json
import threading
import time
from pathlib import Path

import pytest

from tests.secret_samples import SAMPLES
from tests.test_torch_incremental import dbs, edit, make_tree, wd  # noqa: F401
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import commands as jax_commands
from trivy_tpu_torch import cli


INTERVAL = 0.25  # --watch-interval: the pause the fakes stand in for


def counting(monkeypatch, module, name: str) -> list:
    """Wrap ``module.name`` to record each call's result."""
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


def run_watch(tmp: Path, wd: Path, monkeypatch, on_tick, *args: str,
              count: int = 3) -> dict:
    """The port's and the JAX package's ``watch`` over their own copy of one
    seeded tree, ``on_tick(root, n)`` called at the n-th pause (1-based) of
    each. Returns both reports, exit codes, the number of reports each wrote,
    the port's pauses and its last ``--stats-out``."""
    out = {}
    for side in ("port", "jax"):
        root = make_tree(tmp / side)
        report = wd / f"{side}.json"
        ticks: list = []

        def pause(seconds, root=root, ticks=ticks):
            ticks.append(seconds)
            on_tick(root, len(ticks))

        common = ["--format", "json", "-o", str(report), "-q", "--cache-dir",
                  str(wd / f"c-{side}"), "--watch-interval", str(INTERVAL), "--watch-count",
                  str(count), *args, str(root)]
        if side == "port":
            emits = counting(monkeypatch, cli, "_emit")
            monkeypatch.setattr(cli, "_pause", pause)
            rc = cli.main(["watch", "--device", "cpu", "--stats-out", str(wd / "stats.json"),
                           *common])
        else:
            emits = counting(monkeypatch, jax_commands, "_emit")
            real_sleep = time.sleep

            def jax_sleep(seconds, pause=pause):
                # only the watch loop's own pause: the JAX scan's threads and
                # waits share the patched name
                if seconds != INTERVAL or threading.current_thread() is not \
                        threading.main_thread():
                    return real_sleep(seconds)
                return pause(seconds)

            with monkeypatch.context() as m:
                m.setattr(time, "sleep", jax_sleep)
                rc = jax_cli.main(["watch", "--backend", "cpu", *common])
        out[side] = {"rc": rc, "report": json.loads(report.read_text()), "emits": len(emits),
                     "ticks": ticks}
    out["stats"] = json.loads((wd / "stats.json").read_text())
    return out


def test_watch_mode_detects_change(tmp_path, wd, dbs, monkeypatch):
    """Three scans, an edit at the second pause: the unchanged second scan
    writes nothing, the third re-analyzes one unit and writes the report the
    JAX watch writes."""
    def on_tick(root, n):
        if n == 2:
            edit(root / "pkg01" / "cred.txt", "rotated\n", 10**18)

    got = run_watch(tmp_path, wd, monkeypatch, on_tick, "--scanners", "vuln,secret,license",
                    "--db-repository", dbs["dir"])
    port, ref = got["port"], got["jax"]
    assert port["rc"] == ref["rc"] == 0
    assert port["report"]["Results"] == ref["report"]["Results"]
    assert port["report"]["Metadata"] == ref["report"]["Metadata"]
    assert port["emits"] == ref["emits"] == 2
    assert port["ticks"] == ref["ticks"] == [INTERVAL, INTERVAL]
    assert "pkg01" not in json.dumps(port["report"]["Results"])
    assert (got["stats"]["units_analyzed"], got["stats"]["units_reused"]) == (1, 3)


def test_watch_reports_a_deletion(tmp_path, wd, dbs, monkeypatch):
    """A unit removed whole between ticks: no unit is re-analyzed, but the
    set of unit keys changed, so the report is written again."""
    import shutil

    def on_tick(root, n):
        shutil.rmtree(root / "pkg02")

    got = run_watch(tmp_path, wd, monkeypatch, on_tick, "--scanners", "secret", count=2)
    port, ref = got["port"], got["jax"]
    assert port["emits"] == ref["emits"] == 2
    assert port["report"]["Results"] == ref["report"]["Results"]
    assert "pkg02" not in json.dumps(port["report"]) and "pkg01" in json.dumps(port["report"])
    assert (got["stats"]["units_analyzed"], got["stats"]["units_total"]) == (0, 3)


def test_watch_unchanged_tree_writes_one_report(tmp_path, wd, dbs, monkeypatch):
    got = run_watch(tmp_path, wd, monkeypatch, lambda root, n: None, "--scanners", "secret",
                    count=4)
    assert got["port"]["emits"] == got["jax"]["emits"] == 1
    assert got["port"]["report"]["Results"] == got["jax"]["report"]["Results"]
    assert len(got["port"]["ticks"]) == 3


def test_watch_ctrl_c_stops_with_the_last_exit_code(tmp_path, wd, dbs, monkeypatch):
    """``--exit-code 5`` over a tree with secrets, Ctrl-C at the first pause:
    both CLIs return 5 after one report."""
    def on_tick(root, n):
        raise KeyboardInterrupt

    got = run_watch(tmp_path, wd, monkeypatch, on_tick, "--scanners", "secret",
                    "--exit-code", "5", count=0)
    assert got["port"]["rc"] == got["jax"]["rc"] == 5
    assert got["port"]["emits"] == got["jax"]["emits"] == 1


def test_watch_arms_no_timeout_alarm(tmp_path, wd, monkeypatch):
    """``--timeout`` is per scan: ``watch`` sets no alarm, ``fs`` does."""
    import signal

    alarms = []
    monkeypatch.setattr(signal, "alarm", lambda s: alarms.append(s) or 0)
    monkeypatch.setattr(cli, "_pause", lambda s: None)
    root = make_tree(tmp_path, n_dirs=1)
    head = ["--device", "cpu", "-q", "--format", "json", "-o", str(wd / "o.json"),
            "--cache-dir", str(wd / "c"), "--timeout", "1"]
    assert cli.main(["watch", *head, "--watch-count", "2", str(root)]) == 0
    assert alarms == []
    assert cli.main(["fs", *head, str(root)]) == 0
    assert alarms == [1, 0]


@pytest.mark.parametrize("how", ["cli", "env", "config"])
def test_watch_refuses_flags_the_port_lacks(tmp_path, wd, monkeypatch, how):
    """The watch's misconfiguration group takes every type from every
    source, as the JAX watch does (``cloudformation`` and ``helm`` exited 2
    before they were ported): the report equals the JAX CLI's. ``--server``
    and ``--incremental``, which no watch takes, exit 2 in both CLIs."""
    root = make_tree(tmp_path, n_dirs=1)
    (root / "stack.yaml").write_text("AWSTemplateFormatVersion: '2010-09-09'\nResources:\n"
                                     "  B:\n    Type: AWS::S3::Bucket\n")
    argv = ["--scanners", "misconfig", "-q", "--format", "json", "--watch-count", "1"]
    if how == "cli":
        argv += ["--misconfig-scanners", "cloudformation"]
    elif how == "env":
        monkeypatch.setenv("TRIVY_TPU_MISCONFIG_SCANNERS", "cloudformation,helm")
    else:
        (wd / "trivy-tpu.yaml").write_text("misconfiguration:\n  scanners: [cloudformation]\n")
    outs = []
    for tag, main, dev in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, ["--backend", "cpu"])):
        out = wd / f"{tag}.json"
        assert main(["watch", *dev, *argv, "-o", str(out), "--cache-dir", str(wd / tag),
                     str(root)]) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0]["Results"] == outs[1]["Results"]
    assert {r["Type"] for r in outs[0]["Results"]} == {"cloudformation"}
    for flag in ("--server", "--incremental"):
        for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, ["--backend", "cpu"])):
            with pytest.raises(SystemExit) as exc:
                main(["watch", *dev, flag, *(["http://127.0.0.1:9"] if flag == "--server"
                                             else []), str(root)])
            assert exc.value.code == 2


def test_watch_flags_parse():
    ns = cli.build_parser().parse_args(["watch", "--watch-interval", "0.5", "--watch-count",
                                        "3", "/x"])
    assert (ns.watch_interval, ns.watch_count, ns.target) == (0.5, 3, "/x")
    ns = cli.build_parser().parse_args(["watch", "/x"])
    assert (ns.watch_interval, ns.watch_count) == (2.0, 0)


def test_watch_new_secret_is_reported(tmp_path, wd, dbs, monkeypatch):
    """A file with a new secret added at the first pause: the second
    report holds it, as the JAX watch's does."""
    def on_tick(root, n):
        (root / "pkg00" / "new.env").write_text(f"k={SAMPLES['slack-access-token']}\n")

    got = run_watch(tmp_path, wd, monkeypatch, on_tick, "--scanners", "secret", count=2)
    assert got["port"]["emits"] == got["jax"]["emits"] == 2
    assert got["port"]["report"]["Results"] == got["jax"]["report"]["Results"]
    assert "pkg00/new.env" in {r["Target"] for r in got["port"]["report"]["Results"]}
