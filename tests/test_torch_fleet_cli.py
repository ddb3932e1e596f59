"""``--fleet`` on the port's command line (``trivy_tpu_torch/cli.py``: the
fleet flag group, ``_run_fleet`` and ``scan_fleet``) against the same
command without a fleet and against the JAX CLI's ``--fleet``.

- ``fs``, ``rootfs``, ``repo`` and ``image`` take ``--fleet`` with
  ``--fleet-telemetry-interval 0``: the ``Results`` of the scan without a
  fleet; ``fs`` and ``image`` also those of ``trivy_tpu.cli --fleet`` over
  JAX replicas.
- Refusals: ``--fleet`` with ``--server`` and with each incremental flag
  exits 2 with the JAX message; a daemon image exits 1 with the
  ``FleetError`` message.
- The telemetry interval from the command line, the environment, the
  config file or the JAX default 1.0, and ``--fleet-register-token``,
  resolve into the fleet config and scan with the JAX CLI's ``Results``;
  a negative or non-numeric interval exits 2.
- Every replica dead: exit 0 with root ``"Degraded": true`` and the local
  scan's ``Results``; with ``--no-host-fallback`` exit 1.
- ``--stats-out`` holds the coordinator's counters, ``--trace`` the fleet
  efficiency table, ``--secret-hit-cache`` seeds each replica once, the
  ``--fleet-inflight`` knob resolves through the tuning block.
- The new modules import neither ``jax`` nor ``trivy_tpu``.

Replicas are in-process port (or JAX) servers on the CPU; the working
directory holds a two-rule ``trivy-secret.yaml``.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.daemontest import FakeDockerDaemon
from tests.test_torch_fleet_coordinator import DEAD, fleet_threads, replica
from tests.test_torch_fleet_replica import (  # noqa: F401
    RESTRICTED,
    clean_breaker_gauges,
    env,
    shutdown,
)
from tests.test_torch_image_daemon import no_host_daemons, save_tar_bytes  # noqa: F401
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
OFF = ("--fleet-telemetry-interval", "0")


@pytest.fixture
def wd(tmp_path, monkeypatch):
    """A fresh working directory with the two-rule secret config, and no
    fleet or telemetry setting in the environment."""
    d = tmp_path / "wd"
    d.mkdir()
    (d / "trivy-secret.yaml").write_text(RESTRICTED)
    monkeypatch.chdir(d)
    for name in ("FLEET", "FLEET_TELEMETRY_INTERVAL", "FLEET_REGISTER_TOKEN", "FLEET_INFLIGHT"):
        monkeypatch.delenv(f"TRIVY_TPU_{name}", raising=False)
    yield d
    assert not fleet_threads()


@pytest.fixture
def port_fleet():
    servers = [replica("port"), replica("port")]
    yield ",".join(h for _, h in servers)
    shutdown([h for h, _ in servers])


def run(wd, tag: str, command: str, target, *extra: str, main=cli.main) -> tuple[int, dict]:
    """``main`` (the port's or the JAX CLI's) with JSON output under its own
    cache directory; returns (exit code, report or {})."""
    out = wd / f"{tag}.json"
    device = ("--device", "cpu") if main is cli.main else ("--backend", "cpu")
    rc = main([command, *device, "--format", "json", "-q", "-o", str(out), "--cache-dir",
               str(wd / f"cache-{tag}"), *extra, str(target)])
    return rc, json.loads(out.read_text()) if out.exists() else {}


@pytest.mark.parametrize("command", ["fs", "rootfs", "repo", "image"])
def test_fleet_on_each_command_equals_the_scan_without(env, wd, port_fleet, command):
    target = env["image"] if command == "image" else env["tree"]
    args = ("--scanners", "vuln,secret,license", "--license-full", "--db-repository",
            str(env["db"]))
    rc, mine = run(wd, "fleet", command, target, *args, "--fleet", port_fleet, *OFF)
    rc0, alone = run(wd, "alone", command, target, *args)
    assert rc == rc0 == 0
    assert mine["Results"] and mine["Results"] == alone["Results"]
    assert mine["Metadata"] == alone["Metadata"] and "Degraded" not in mine


@pytest.mark.parametrize("command", ["fs", "image"])
def test_fleet_equals_the_jax_cli_fleet(env, wd, port_fleet, command):
    target = env["image"] if command == "image" else env["tree"]
    servers = [replica("jax"), replica("jax")]
    try:
        args = ("--scanners", "secret,license", "--license-full")
        rc, mine = run(wd, "port", command, target, *args, "--fleet", port_fleet, *OFF)
        jrc, ref = run(wd, "jax", command, target, *args, "--fleet",
                       ",".join(h for _, h in servers), *OFF, main=jax_cli.main)
    finally:
        shutdown([h for h, _ in servers])
    assert rc == jrc == 0
    assert mine["Results"] and mine["Results"] == ref["Results"]


@pytest.mark.parametrize("command,extra,message", [
    ("fs", ("--server", "http://127.0.0.1:9"), "--fleet and --server are mutually exclusive"),
    ("image", ("--server", "http://127.0.0.1:9"), "--fleet and --server are mutually exclusive"),
    ("fs", ("--incremental",), "do not compose with --fleet"),
    ("fs", ("--since-last",), "do not compose with --fleet"),
    ("repo", ("--diff-base", "HEAD"), "do not compose with --fleet"),
])
def test_fleet_refusals_exit_2(env, wd, capsys, command, extra, message):
    target = env["image"] if command == "image" else env["tree"]
    rc, _ = run(wd, "refused", command, target, "--fleet", DEAD[0], *OFF, *extra)
    assert rc == 2 and message in capsys.readouterr().err


@pytest.fixture(scope="module")
def jax_secret_results(env, tmp_path_factory):
    """The JAX CLI's ``fs --scanners secret`` of the tree without a fleet,
    from a working directory with the two-rule config."""
    d = tmp_path_factory.mktemp("jax-secret")
    (d / "trivy-secret.yaml").write_text(RESTRICTED)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        rc, doc = run(d, "jax", "fs", env["tree"], "--scanners", "secret", main=jax_cli.main)
    finally:
        os.chdir(cwd)
    assert rc == 0 and doc["Results"]
    return doc["Results"]


@pytest.mark.parametrize("how,interval,bad", [
    ("cli", 1.0, "-1"), ("env", 0.5, "abc"), ("config", 2.0, "-2"), ("default", 1.0, None),
    ("register-token", 1.0, None)], ids=["cli", "env", "config", "default", "register-token"])
def test_telemetry_settings_exit_2(env, wd, monkeypatch, port_fleet, jax_secret_results, how,
                                   interval, bad):
    """Each source of the interval resolves into the fleet config (the
    register token too) and the scan runs the telemetry plane with the JAX
    CLI's ``Results``; a negative or non-numeric interval from the same
    source still exits 2."""
    def source(value: str) -> list:
        if how == "cli":
            return ["--fleet-telemetry-interval", value]
        if how == "env":
            monkeypatch.setenv("TRIVY_TPU_FLEET_TELEMETRY_INTERVAL", value)
        elif how == "config":
            (wd / "trivy-tpu.yaml").write_text(f"fleet:\n  telemetry-interval: {value}\n")
        elif how == "register-token":
            return ["--fleet-register-token", value]
        return []

    configs = []
    orig = cli.scan_fleet

    def spy(kind, target, fleet, **kw):
        configs.append((fleet.telemetry_interval, fleet.register_token))
        return orig(kind, target, fleet, **kw)

    monkeypatch.setattr(cli, "scan_fleet", spy)
    extra = source(str(interval) if how != "register-token" else "R")
    rc, mine = run(wd, "plane", "fs", env["tree"], "--scanners", "secret", "--fleet", port_fleet,
                   "--metrics-out", str(wd / "m.json"), *extra)
    assert rc == 0 and mine["Results"] == jax_secret_results and "Degraded" not in mine
    assert configs == [(interval, "R" if how == "register-token" else "")]
    fleet = json.loads((wd / "m.json").read_text())["fleet"]
    assert fleet["interval_s"] == interval
    assert sorted(fleet["replicas"]) == sorted(port_fleet.split(","))
    if bad is not None:
        extra = source(bad)
        with pytest.raises(SystemExit) as exc:
            run(wd, "bad", "fs", env["tree"], "--fleet", port_fleet, *extra)
        assert exc.value.code == 2


def test_the_fleet_from_the_environment_and_config(env, wd, monkeypatch, port_fleet):
    """``TRIVY_TPU_FLEET`` and ``fleet.replicas`` with the interval from the
    config file run the fleet as the flags do."""
    monkeypatch.setenv("TRIVY_TPU_FLEET", port_fleet)
    (wd / "trivy-tpu.yaml").write_text("fleet:\n  telemetry-interval: 0\n")
    rc, mine = run(wd, "envfleet", "fs", env["tree"], "--stats-out", str(wd / "s.json"))
    assert rc == 0 and mine["Results"]
    assert json.loads((wd / "s.json").read_text())["fleet.shards"] >= 4


def test_daemon_image_exits_1(wd, tmp_path, capsys):
    daemon = FakeDockerDaemon(str(tmp_path / "docker.sock")).start()
    try:
        daemon.add_image("alpine:3.18", save_tar_bytes(tmp_path, "alpine:3.18"))
        rc, doc = run(wd, "daemon", "image", "docker://alpine:3.18", "--image-src", "docker",
                      "--docker-host", f"unix://{daemon.socket_path}", "--fleet", DEAD[0], *OFF)
    finally:
        daemon.stop()
    err = capsys.readouterr().err
    assert rc == 1 and not doc
    assert "fleet scan failed:" in err and "local daemon export" in err


def test_all_dead_degrades_or_exits_1(env, wd, capsys):
    rc, mine = run(wd, "dead", "fs", env["tree"], "--fleet", ",".join(DEAD), *OFF)
    rc0, alone = run(wd, "alone", "fs", env["tree"])
    assert rc == rc0 == 0
    assert mine["Degraded"] is True and "Degraded" not in alone
    assert mine["Results"] == alone["Results"]
    capsys.readouterr()
    rc, doc = run(wd, "loud", "fs", env["tree"], "--fleet", ",".join(DEAD), *OFF,
                  "--no-host-fallback")
    assert rc == 1 and not doc
    assert "fleet scan failed:" in capsys.readouterr().err


def test_stats_trace_warm_seed_and_tuning(env, wd, port_fleet, capsys):
    """A local ``--secret-hit-cache`` scan fills the cache; the fleet scan
    on it ships the warm entries once per replica, counts its fan-out in
    ``--stats-out``, prints the efficiency table with ``--trace`` and
    resolves ``--fleet-inflight`` through the tuning block."""
    cache = ["--cache-dir", str(wd / "warm"), "--secret-hit-cache"]
    assert cli.main(["fs", "--device", "cpu", "-q", "--format", "json", "-o",
                     str(wd / "first.json"), *cache, str(env["tree"])]) == 0
    capsys.readouterr()
    assert cli.main(["fs", "--device", "cpu", "--format", "json", "-o", str(wd / "f.json"),
                     *cache, "--fleet", port_fleet, *OFF, "--fleet-split-threshold", "0",
                     "--fleet-inflight", "3", "--trace",
                     "--stats-out", str(wd / "s.json"), "--metrics-out", str(wd / "m.json"),
                     str(env["tree"])]) == 0
    stats = json.loads((wd / "s.json").read_text())
    assert stats["fleet.replicas"] == 2 and stats["fleet.warm_seeded"] == 2
    assert stats["fleet.dispatches"] >= stats["fleet.shards"] >= 4
    assert sum(stats["fleet.replica_shards"].values()) == stats["fleet.shards"]
    assert stats["fleet.fanout.seconds"] > 0 and stats["detect.seconds"] >= 0
    assert "-- fleet efficiency" in capsys.readouterr().err
    tuning = json.loads((wd / "m.json").read_text())["tuning"]["config"]
    assert tuning["fleet_inflight"] == 3 and tuning["source"]["fleet_inflight"] == "cli"
    assert (json.loads((wd / "f.json").read_text())["Results"]
            == json.loads((wd / "first.json").read_text())["Results"])


def test_fleet_flags_equal_jax():
    """The fleet group's names, config keys, defaults and types are the JAX
    CLI's."""
    def shape(group):
        return [(f.name, f.config_name, f.default, f.value_type, f.is_list)
                for f in group.flags]

    assert shape(cli.fleet_flags()) == shape(jax_cli.fleet_flags())


NEW_MODULES = ("trivy_tpu_torch.fleet.coordinator", "trivy_tpu_torch.fleet.merge",
               "trivy_tpu_torch.fleet.telemetry", "trivy_tpu_torch.fleet.controller",
               "trivy_tpu_torch.cli")


def test_new_modules_import_neither_jax_nor_the_jax_package():
    for mod in NEW_MODULES:
        path = REPO / (mod.replace(".", "/") + ".py")
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "trivy_tpu"), (mod, name)
    code = ("import sys; import " + ", ".join(NEW_MODULES)
            + "; from trivy_tpu_torch.secret.hitstore import export_backend_warm"
            + "; bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'trivy_tpu')]"
            + "; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_the_shards_carry_the_secret_configs_absolute_path(env, wd, port_fleet, monkeypatch):
    """The working directory's ``trivy-secret.yaml`` reaches the shards as
    an absolute path, so a replica running elsewhere opens the same file."""
    wires = []
    orig = cli.scan_fleet

    def spy(kind, target, fleet, **kw):
        wires.append(kw["config_path"])
        return orig(kind, target, fleet, **kw)

    monkeypatch.setattr(cli, "scan_fleet", spy)
    rc, doc = run(wd, "abs", "fs", env["tree"], "--fleet", port_fleet, *OFF)
    assert rc == 0 and doc["Results"]
    assert wires == [str(wd / "trivy-secret.yaml")]
