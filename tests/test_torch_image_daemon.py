"""The port's daemon image sources (docker, podman, containerd) against the
JAX package's, on the in-process Docker Engine of ``tests/daemontest.py``
(ref: pkg/fanal/image/image.go:27-58 resolution order, daemon clients in
pkg/fanal/image/daemon/): the tests of ``tests/test_image_daemon.py`` on the
port, each report equal to the JAX package's on the same daemon. The socket
lists are patched and ``DOCKER_HOST`` unset, so no test reaches a daemon of
the machine."""

import json
import os
import socket

import pytest

from tests.daemontest import FakeDockerDaemon
from tests.imagetest import docker_save_tar, tar_bytes
from tests.test_torch_match import few_torch_threads  # noqa: F401
from trivy_tpu import cli as jax_cli
from trivy_tpu.artifact.image import new_image_artifact as jax_new_image_artifact
from trivy_tpu.artifact.local_fs import ArtifactOption
from trivy_tpu.cache import new_cache as jax_new_cache
from trivy_tpu.fanal import image_daemon as jax_daemon
from trivy_tpu.scanner import ScanOptions, Scanner
from trivy_tpu.scanner.local_driver import LocalDriver
from trivy_tpu_torch import cli
from trivy_tpu_torch.artifact import image as port_image
from trivy_tpu_torch.artifact.image import ImageSourceOption
from trivy_tpu_torch.cache import new_cache
from trivy_tpu_torch.fanal import image_daemon as port_daemon
from trivy_tpu_torch.fanal.image_daemon import ContainerdSource, DaemonError
from trivy_tpu_torch.fanal.scan import ScanAnalyzers

GHP = "ghp_" + "A1b2C3d4E5f6G7h8I9j0K1l2M3n4O5p6Q7r8"


def save_tar_bytes(tmp_path, ref: str) -> bytes:
    layer = tar_bytes({"etc/os-release": b"ID=alpine\nVERSION_ID=3.18.4\n",
                       "app/cred.txt": f"token {GHP}\n".encode()})
    p = tmp_path / "img.tar"
    docker_save_tar(str(p), [layer], repo_tag=ref)
    return p.read_bytes()


@pytest.fixture(autouse=True)
def no_host_daemons(monkeypatch):
    """No socket of the machine is probed, in either package."""
    monkeypatch.delenv("DOCKER_HOST", raising=False)
    for mod in (jax_daemon, port_daemon):
        for name in ("DOCKER_SOCKETS", "PODMAN_SOCKETS", "CONTAINERD_SOCKETS"):
            monkeypatch.setattr(mod, name, [])


@pytest.fixture
def daemon(tmp_path):
    d = FakeDockerDaemon(str(tmp_path / "docker.sock")).start()
    d.add_image("alpine:3.18", save_tar_bytes(tmp_path, "alpine:3.18"))
    yield d
    d.stop()


def scan(target: str, cache_dir, **opt) -> dict:
    """The port's secret scan of ``target`` (``opt``: the source options)."""
    report, _ = cli.scan_image(target, device="cpu", cache_dir=str(cache_dir),
                               image_source=ImageSourceOption(**opt))
    return report.to_dict()


def jax_scan(target: str, cache_dir, **opt) -> dict:
    cache = jax_new_cache("fs", str(cache_dir))
    artifact = jax_new_image_artifact(target, cache, ArtifactOption(backend="cpu", **opt))
    report = Scanner(artifact, LocalDriver(cache)).scan_artifact(ScanOptions(scanners=["secret"]))
    return json.loads(json.dumps(report.to_dict(), default=str))


def assert_same(mine: dict, ref: dict) -> None:
    assert mine["Results"] == ref["Results"] and mine["Metadata"] == ref["Metadata"]
    assert mine["ArtifactName"] == ref["ArtifactName"] == "alpine:3.18"


def secret_rules(report: dict) -> set:
    return {s["RuleID"] for r in report["Results"] for s in r.get("Secrets", [])}


def test_docker_daemon_scan(daemon, tmp_path):
    mine = scan("alpine:3.18", tmp_path / "c1", docker_host=daemon.socket_path)
    assert_same(mine, jax_scan("alpine:3.18", tmp_path / "c2", docker_host=daemon.socket_path))
    assert secret_rules(mine) == {"github-pat"}
    # the daemon served both inspect and export
    assert any(p.endswith("/json") for p in daemon.requests)
    assert any(p.endswith("/get") for p in daemon.requests)


def test_docker_prefix_forces_daemon_cli(daemon, tmp_path, monkeypatch):
    """``image docker://<ref> --image-src docker --docker-host unix://...``
    through both CLIs."""
    monkeypatch.chdir(tmp_path)
    args = ["--scanners", "secret", "--format", "json", "-q", "--image-src", "docker",
            "--docker-host", f"unix://{daemon.socket_path}", "docker://alpine:3.18"]
    assert cli.main(["image", "--device", "cpu", "-o", "port.json", "--cache-dir", "c1",
                     *args]) == 0
    assert jax_cli.main(["image", "--backend", "cpu", "-o", "jax.json", "--cache-dir", "c2",
                         *args]) == 0
    mine = json.loads((tmp_path / "port.json").read_text())
    assert_same(mine, json.loads((tmp_path / "jax.json").read_text()))
    assert secret_rules(mine) == {"github-pat"}


def test_docker_prefix_missing_image_errors(daemon, tmp_path):
    for run, err in ((scan, DaemonError), (jax_scan, jax_daemon.DaemonError)):
        with pytest.raises(err, match="not found"):
            run("docker://nosuch:latest", tmp_path / "c", docker_host=daemon.socket_path)
    out = tmp_path / "port.json"
    assert cli.main(["image", "--device", "cpu", "-q", "-o", str(out), "--cache-dir",
                     str(tmp_path / "c"), "--docker-host", daemon.socket_path,
                     "docker://nosuch:latest"]) == 1
    assert not out.exists()


def test_no_daemon_clean_error_without_remote(tmp_path):
    opt = dict(docker_host=str(tmp_path / "absent.sock"), image_src=["docker", "podman"])
    for run, err in ((scan, DaemonError), (jax_scan, jax_daemon.DaemonError)):
        with pytest.raises(err, match="'remote' is not enabled"):
            run("alpine:3.18", tmp_path / "c", **opt)


def test_podman_socket_resolution(daemon, tmp_path):
    opt = dict(image_src=["podman"], podman_host=daemon.socket_path)
    mine = scan("alpine:3.18", tmp_path / "c1", **opt)
    assert_same(mine, jax_scan("alpine:3.18", tmp_path / "c2", **opt))


def test_resolution_order_prefers_docker_over_remote(daemon, tmp_path):
    # the docker socket holds the image: no registry involved
    opt = dict(docker_host=daemon.socket_path, image_src=["docker", "remote"])
    mine = scan("alpine:3.18", tmp_path / "c1", **opt)
    assert_same(mine, jax_scan("alpine:3.18", tmp_path / "c2", **opt))
    assert any(p.endswith("/get") for p in daemon.requests)


def test_containerd_detected_with_clear_error(tmp_path):
    sock = tmp_path / "containerd.sock"
    sock.touch()
    opt = ImageSourceOption(containerd_host=str(sock))
    src = port_daemon.resolve_daemon_source("x:1", ["containerd"], opt)
    assert isinstance(src, ContainerdSource)
    with pytest.raises(DaemonError, match="ctr images export"):
        src.export_to(str(tmp_path / "out.tar"))
    # beside other sources the socket blocks nothing
    assert port_daemon.resolve_daemon_source("x:1", ["containerd", "remote"], opt) is None
    # through the CLI, the refusal exits 1 with no report
    out = tmp_path / "port.json"
    assert cli.main(["image", "--device", "cpu", "-q", "-o", str(out), "--cache-dir",
                     str(tmp_path / "c"), "--containerd-host", str(sock),
                     "containerd://x:1"]) == 1
    assert not out.exists()


def test_temp_archive_cleaned_up(daemon, tmp_path, monkeypatch):
    an = ScanAnalyzers(["secret"], "cpu", packages=True)
    art = port_image.new_image_artifact("alpine:3.18", new_cache("memory"), an,
                                        option=ImageSourceOption(docker_host=daemon.socket_path))
    assert isinstance(art, port_image.DaemonImageArtifact)
    tmp = art._tmp
    assert os.path.exists(tmp)
    art.close()
    assert not os.path.exists(tmp)
    # a scan removes its export, and so does a scan that fails
    made = []
    real = port_image.export_to_tempfile
    monkeypatch.setattr(port_image, "export_to_tempfile",
                        lambda src: made.append(real(src)) or made[-1])
    scan("alpine:3.18", tmp_path / "c1", docker_host=daemon.socket_path)

    def fail(self):
        raise RuntimeError("layer walk failed")

    monkeypatch.setattr(port_image.ImageArchiveArtifact, "inspect", fail)
    with pytest.raises(RuntimeError, match="layer walk failed"):
        scan("alpine:3.18", tmp_path / "c2", docker_host=daemon.socket_path)
    assert len(made) == 2 and not any(os.path.exists(p) for p in made)


def dead_socket(path: str) -> str:
    """A socket file nothing listens on: bound once, then closed."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.bind(path)
    s.close()
    return path


def test_resolution_order_walks_dead_docker_to_live_podman(daemon, tmp_path, monkeypatch):
    """The docker socket exists but nothing listens, a containerd socket
    exists (its API is not spoken, so it is skipped), the podman socket is
    live and holds the image: the walk lands on podman, in both packages."""
    dead = dead_socket(str(tmp_path / "dead-docker.sock"))
    ctrd = str(tmp_path / "containerd.sock")
    open(ctrd, "w").close()
    for mod in (jax_daemon, port_daemon):
        monkeypatch.setattr(mod, "DOCKER_SOCKETS", [dead])
        monkeypatch.setattr(mod, "CONTAINERD_SOCKETS", [ctrd])
        monkeypatch.setattr(mod, "PODMAN_SOCKETS", [daemon.socket_path])
    source = port_daemon.resolve_daemon_source(
        "alpine:3.18", ["docker", "containerd", "podman", "remote"], ImageSourceOption())
    assert source is not None and source.api == "podman"
    assert source.host == daemon.socket_path
    mine = scan("alpine:3.18", tmp_path / "c1")
    assert_same(mine, jax_scan("alpine:3.18", tmp_path / "c2"))
    assert secret_rules(mine) == {"github-pat"}


def test_resolution_order_all_daemons_dead_falls_to_registry_gate(tmp_path):
    """With every daemon socket absent and ``remote`` left out, the walk
    ends in a clear error, never a registry pull."""
    an = ScanAnalyzers(["secret"], "cpu", packages=True)
    src = ["docker", "containerd", "podman"]
    with pytest.raises(DaemonError):
        port_image.new_image_artifact("nope:latest", new_cache("memory"), an,
                                      option=ImageSourceOption(image_src=src))
    with pytest.raises(jax_daemon.DaemonError):
        jax_new_image_artifact("nope:latest", jax_new_cache("memory"),
                               ArtifactOption(backend="cpu", image_src=src))
