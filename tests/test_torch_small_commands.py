"""The port's small commands and global flags against the JAX CLI, on the
CPU: ``version``, ``clean``, ``plugin`` (the flows of ``tests/test_aux.py``
through both CLIs over one plugin root), ``-d`` and ``--log-format json``
(the port's lines against the JAX formatter's), ``--backend`` with and
without ``--device``, and the db flags ``--skip-db-update`` and
``--offline-scan`` from the command line, the environment and the config
file.
"""

from __future__ import annotations

import io
import json
import logging
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import pytest

from tests.secret_samples import SAMPLES
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu import log as jax_log
from trivy_tpu import plugin as jax_plugin
from trivy_tpu_torch import VERSION, cli, log, obs, plugin

REPO = Path(__file__).resolve().parent.parent
SECRET_CONFIG = "enable-builtin-rules:\n  - github-pat\n"


@pytest.fixture
def wd(tmp_path, monkeypatch):
    """A fresh working directory with a two-rule secret config and a tree
    holding one secret, under a plugin root of its own."""
    d = tmp_path / "wd"
    (d / "tree" / "src").mkdir(parents=True)
    (d / "tree" / "src" / "a.py").write_text(f"token = '{SAMPLES['github-pat']}'\n")
    (d / "trivy-secret.yaml").write_text(SECRET_CONFIG)
    monkeypatch.chdir(d)
    monkeypatch.setenv("TRIVY_TPU_HOME", str(tmp_path / "home"))
    return d


def restore_loggers():
    """Both CLIs leave their root logger configured; put them back so later
    modules in the worker read records through ``caplog``."""
    for name in ("trivy_tpu", "trivy_tpu_torch"):
        root = logging.getLogger(name)
        for h in list(root.handlers):
            root.removeHandler(h)
        root.propagate = True
        root.setLevel(logging.NOTSET)


# -- version -----------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_version_equals_jax(fmt, capsys):
    assert cli.main(["version", "--format", fmt]) == 0
    mine = capsys.readouterr().out
    assert jax_cli.main(["version", "--format", fmt]) == 0
    assert mine == capsys.readouterr().out
    assert VERSION in mine
    if fmt == "json":
        assert json.loads(mine) == {"Version": VERSION}


# -- clean -------------------------------------------------------------------


def populated(cache_dir: Path) -> None:
    (cache_dir / "fanal" / "blob").mkdir(parents=True, exist_ok=True)
    (cache_dir / "fanal" / "blob" / "x.json").write_text("{}")
    (cache_dir / "db").mkdir(exist_ok=True)
    (cache_dir / "db" / "metadata.json").write_text("{}")


def listing(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*"))


@pytest.mark.parametrize("flags", [[], ["--scan-cache"], ["--vuln-db"], ["--all"],
                                   ["--scan-cache", "--vuln-db"]])
def test_clean_equals_jax(wd, flags):
    trees = []
    rcs = []
    for main, tag in ((cli.main, "port"), (jax_cli.main, "jax")):
        c = wd / f"cache-{tag}"
        populated(c)
        rcs.append(main(["clean", *flags, "-q", "--cache-dir", str(c)]))
        trees.append(listing(c))
    restore_loggers()
    assert rcs[0] == rcs[1] == (1 if not flags else 0)
    assert trees[0] == trees[1]
    if "--all" in flags or "--vuln-db" in flags:
        assert "db" not in trees[0]
    if "--all" in flags or "--scan-cache" in flags:
        assert "fanal/blob/x.json" not in trees[0]


def test_clean_of_a_missing_db_and_the_config_key(wd, capsys):
    (wd / "trivy-tpu.yaml").write_text(f"cache:\n  dir: {wd / 'c'}\n")
    assert cli.main(["clean", "--vuln-db"]) == 0
    assert not (wd / "c" / "db").exists()
    restore_loggers()


def test_clean_takes_no_scan_flags(wd):
    with pytest.raises(SystemExit):
        cli.main(["clean", "--all", "--device", "cpu"])


# -- plugin ------------------------------------------------------------------


@pytest.fixture
def plugin_src(tmp_path):
    src = tmp_path / "hello"
    src.mkdir()
    (src / "plugin.yaml").write_text(
        "name: hello\nversion: 1.0.0\nsummary: say hello\n"
        "platforms:\n  - bin: ./hello.sh\n"
    )
    binf = src / "hello.sh"
    binf.write_text("#!/bin/sh\necho hello-from-plugin $1\nexit 7\n")
    binf.chmod(0o755)
    return src


def test_plugin_install_list_run_uninstall_equal_jax(tmp_path, plugin_src, capfd):
    root = str(tmp_path / "plugins")
    assert plugin.install(str(plugin_src), root=root) == jax_plugin.install(
        str(plugin_src), root=str(tmp_path / "jax-plugins"))
    assert plugin.list_installed(root=root) == jax_plugin.list_installed(root=root)
    assert plugin.run("hello", ["world"], root=root) == 7
    assert "hello-from-plugin world" in capfd.readouterr().out
    assert plugin.uninstall("hello", root=root)
    assert plugin.list_installed(root=root) == []
    assert not plugin.uninstall("hello", root=root)


def test_plugin_install_archive(tmp_path, plugin_src):
    archive = tmp_path / "hello.tar.gz"
    with tarfile.open(archive, "w:gz") as tf:
        tf.add(plugin_src, arcname="hello")
    root = str(tmp_path / "plugins2")
    assert plugin.install(str(archive), root=root)["name"] == "hello"
    assert plugin.run("hello", [], root=root) == 7


def test_plugin_errors(tmp_path, plugin_src):
    with pytest.raises(plugin.PluginError):
        plugin.run("ghost", [], root=str(tmp_path / "empty"))
    with pytest.raises(plugin.PluginError, match="unsupported"):
        plugin.install(str(tmp_path / "x.zip"), root=str(tmp_path / "p"))
    (plugin_src / "plugin.yaml").write_text(
        "name: hello\nversion: 1.0.0\n"
        "platforms:\n  - selector: {os: plan9}\n    bin: ./hello.sh\n")
    root = str(tmp_path / "plugins3")
    plugin.install(str(plugin_src), root=root)
    with pytest.raises(plugin.PluginError, match="no platform"):
        plugin.run("hello", [], root=root)


def test_plugin_cli_flows_across_packages(wd, plugin_src, capfd):
    """A plugin installed by one CLI is listed, run and uninstalled by the
    other: both use ``$TRIVY_TPU_HOME/plugins`` (``~/.trivy-tpu/plugins``)."""
    assert cli.main(["plugin", "install", str(plugin_src)]) == 0
    assert capfd.readouterr().out == "installed hello 1.0.0\n"
    assert jax_cli.main(["plugin", "list"]) == 0
    jax_list = capfd.readouterr().out
    assert cli.main(["plugin", "list"]) == 0
    assert capfd.readouterr().out == jax_list == "hello\t1.0.0\tsay hello\n"
    assert cli.main(["plugin", "run", "hello", "--flag", "x"]) == 7
    assert "hello-from-plugin --flag" in capfd.readouterr().out
    assert jax_cli.main(["plugin", "uninstall", "hello"]) == 0
    assert cli.main(["plugin", "uninstall", "hello"]) == 0
    assert capfd.readouterr().out == "removed\nhello is not installed\n"
    for args in (["run", "ghost"], ["install", str(wd / "nothing.zip")]):
        assert cli.main(["plugin", *args]) == jax_cli.main(["plugin", *args]) == 1
    bad = wd / "bad.tar.gz"
    bad.write_bytes(b"not a tar")
    assert cli.main(["plugin", "install", str(bad)]) == jax_cli.main(
        ["plugin", "install", str(bad)]) == 1
    with pytest.raises(SystemExit) as exc:
        cli.main(["plugin"])
    assert exc.value.code == 0


# -- logging -----------------------------------------------------------------


def records():
    """Log records of several subsystems, levels and an exception."""
    out = []
    for name, level, msg, args in (("cli", logging.INFO, "scan of %s", ("x",)),
                                   ("fleet.coordinator", logging.WARNING, "slow %d", (3,)),
                                   (None, logging.DEBUG, "root line", ()),
                                   ("misconf", logging.ERROR, "bad", ())):
        for root in ("trivy_tpu", "trivy_tpu_torch"):
            rec = logging.LogRecord(f"{root}.{name}" if name else root, level, __file__, 1,
                                    msg, args, None)
            rec.created = 1760000000.25
            out.append(rec)
    try:
        raise ValueError("boom")
    except ValueError:
        for root in ("trivy_tpu", "trivy_tpu_torch"):
            rec = logging.LogRecord(f"{root}.x", logging.ERROR, __file__, 1, "fail", (),
                                    sys.exc_info())
            rec.created = 1760000000.5
            out.append(rec)
    return out


def test_json_lines_equal_the_jax_formatter():
    """Record for record, the port's JSON line equals the JAX formatter's on
    the same record under the JAX root, in one trace context."""
    recs = records()
    with obs.scan_context(name="t") as ctx:
        mine = [log._JSONFormatter().format(r) for r in recs[1::2]]
    from trivy_tpu import obs as jax_obs

    with jax_obs.scan_context(name="t", trace_id=ctx.trace_id):
        ref = [jax_log._JSONFormatter().format(r) for r in recs[0::2]]
    assert mine == ref
    docs = [json.loads(line) for line in mine]
    assert [d["subsystem"] for d in docs] == ["cli", "fleet.coordinator", "root", "misconf", "x"]
    assert all(d["trace_id"] == ctx.trace_id for d in docs) and "boom" in docs[-1]["exc"]


@pytest.mark.parametrize("fmt,debug", [("plain", False), ("json", True), ("json", False)])
def test_log_init_levels_and_formats(fmt, debug):
    stream = io.StringIO()
    log.init(debug=debug, fmt=fmt, stream=stream)
    try:
        log.logger("cli").debug("d-line")
        log.logger("cli").info("i-line")
    finally:
        restore_loggers()
    lines = stream.getvalue().splitlines()
    assert len(lines) == (2 if debug else 1)
    if fmt == "json":
        assert json.loads(lines[-1])["msg"] == "i-line"
    else:
        assert "INFO [trivy_tpu_torch.cli] i-line" in lines[-1]


def run_port(*args, env=None, cwd=None):
    e = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-m", "trivy_tpu_torch", *args], cwd=cwd,
                          env={**e, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
                          timeout=300)


def test_debug_json_scan_lines_carry_the_trace(wd):
    """``-d --log-format json``: every stderr line of a scan is a JSON
    object with the scan's ``trace_id`` (one id throughout), debug lines
    included; ``-d`` from the environment and the config file does the
    same; without it no debug line is written."""
    for args, env in (((), {}), (("-d", "--log-format", "json"), {}),
                      (("--log-format", "json"), {"TRIVY_TPU_DEBUG": "true"})):
        p = run_port("fs", "--scanners", "secret", "--device", "cpu", "--format", "json",
                     "-o", str(wd / "out.json"), *args, "tree", env=env, cwd=wd)
        assert p.returncode == 0, p.stderr
        lines = p.stderr.splitlines()
        if not args:
            assert not any(" DEBUG " in ln for ln in lines)
            continue
        docs = [json.loads(ln) for ln in lines]
        assert any(d["level"] == "DEBUG" for d in docs)
        assert len({d["trace_id"] for d in docs}) == 1
    (wd / "trivy-tpu.yaml").write_text("debug: true\nlog:\n  format: json\n")
    p = run_port("fs", "--scanners", "secret", "--device", "cpu", "-o", str(wd / "o.json"),
                 "tree", cwd=wd)
    assert p.returncode == 0 and json.loads(p.stderr.splitlines()[0])["level"] == "DEBUG"


def test_bad_log_format_exits_2(wd):
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["fs", "--log-format", "xml", "tree"])
        assert exc.value.code == 2


# -- --backend and --device --------------------------------------------------


@pytest.mark.parametrize("args,device", [
    ((), "cuda"), (("--backend", "cpu"), "cpu"), (("--backend", "auto"), "cuda"),
    (("--backend", "xla"), "cuda"), (("--backend", "pallas"), "cuda"),
    (("--backend", "pallas", "--device", "cpu"), "cpu"),
    (("--backend", "cpu", "--device", "cuda"), "cuda"), (("--device", "cpu"), "cpu"),
])
def test_backend_maps_to_the_device(wd, monkeypatch, args, device):
    """``cpu`` runs on the CPU, the other backends on the card, and an
    explicit ``--device`` wins."""
    seen = []

    def fake(target, **kw):
        seen.append(kw["device"])
        raise SystemExit(0)

    monkeypatch.setattr(cli, "scan_fs", fake)
    with pytest.raises(SystemExit):
        cli.main(["fs", "-q", *args, "tree"])
    assert seen == [device]


@pytest.mark.parametrize("source", ["env", "config"])
def test_backend_from_env_and_config(wd, monkeypatch, source):
    if source == "env":
        monkeypatch.setenv("TRIVY_TPU_BACKEND", "cpu")
    else:
        (wd / "trivy-tpu.yaml").write_text("scan:\n  backend: cpu\n")
    out = wd / "port.json"
    assert cli.main(["fs", "--scanners", "secret", "-q", "--format", "json", "-o", str(out),
                     "tree"]) == 0
    ref = wd / "jax.json"
    assert jax_cli.main(["fs", "--scanners", "secret", "-q", "--format", "json", "-o",
                         str(ref), "--cache-dir", str(wd / "c"), "tree"]) == 0
    restore_loggers()
    assert json.loads(out.read_text())["Results"] == json.loads(ref.read_text())["Results"]


def test_bad_backend_exits_2(wd, monkeypatch):
    with pytest.raises(SystemExit) as exc:
        cli.main(["fs", "--backend", "tpu", "tree"])
    assert exc.value.code == 2
    monkeypatch.setenv("TRIVY_TPU_BACKEND", "gpu")
    with pytest.raises(SystemExit) as exc:
        cli.main(["fs", "--device", "cpu", "tree"])
    assert exc.value.code == 2


# -- the db flags ------------------------------------------------------------


@pytest.mark.parametrize("command", ["fs", "sbom", "server"])
@pytest.mark.parametrize("source", ["cli", "env", "config"])
def test_db_flags_taken_from_every_source(wd, monkeypatch, command, source):
    """``--skip-db-update`` and ``--offline-scan`` resolve from the command
    line, the environment and the config file on every command with the db
    group, and change nothing."""
    extra = []
    if source == "cli":
        extra = ["--skip-db-update", "--offline-scan"]
    elif source == "env":
        monkeypatch.setenv("TRIVY_TPU_SKIP_DB_UPDATE", "true")
        monkeypatch.setenv("TRIVY_TPU_OFFLINE_SCAN", "1")
    else:
        (wd / "trivy-tpu.yaml").write_text("db:\n  skip-update: true\noffline-scan: true\n")
    parser = cli.build_parser()
    target = {"fs": ["tree"], "sbom": ["bom.json"], "server": []}[command]
    args = parser.parse_args([command, *extra, *target])
    from trivy_tpu_torch.flag import load_config_file, resolve_all

    opts = resolve_all(args._groups_by_cmd[command], args, load_config_file(None))
    assert opts["skip_db_update"] is True and opts["offline_scan"] is True
    if command == "fs":
        out = wd / "port.json"
        assert cli.main(["fs", "--scanners", "secret", "--device", "cpu", "-q", "--format",
                         "json", "-o", str(out), *extra, "tree"]) == 0
        assert json.loads(out.read_text())["Results"][0]["Target"] == "src/a.py"
