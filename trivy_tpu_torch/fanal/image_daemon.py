"""Container-runtime daemon image sources (docker / podman / containerd),
the port's copy of ``trivy_tpu/fanal/image_daemon.py``.

The reference resolves an image reference through runtime daemons before
falling back to the registry (ref: pkg/fanal/image/image.go:27-58, clients
in pkg/fanal/image/daemon/):

- **docker**: Docker Engine REST API over the unix socket (or a
  ``DOCKER_HOST`` tcp/unix URL). The image is exported with
  ``GET /images/{ref}/get`` — the ``docker save`` wire format — which the
  archive reader of ``artifact/image.py`` already parses, so the daemon
  source is *only* a byte source, exactly like the registry one.
- **podman**: same REST API (podman serves the Docker-compatible endpoint)
  at the rootless or root podman socket.
- **containerd**: its control API is gRPC over protobuf, which this
  zero-dependency build does not speak; the socket is *detected* and the
  error tells the user to export (``ctr images export``) or use another
  source. The seam (``ContainerdSource``) is where a real client plugs in.

Everything is testable without a daemon: an in-process HTTP server on a
unix socket serving the three endpoints this module uses
(tests/daemontest.py) stands in for the engine.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import tempfile
import urllib.parse

from trivy_tpu_torch import log

logger = log.logger("image:daemon")

DOCKER_SOCKETS = ["/var/run/docker.sock", "/run/docker.sock"]
PODMAN_SOCKETS = [
    "{xdg}/podman/podman.sock",
    "/run/podman/podman.sock",
    "/var/run/podman/podman.sock",
]
CONTAINERD_SOCKETS = ["/run/containerd/containerd.sock"]


class DaemonError(Exception):
    """Daemon unreachable or the image is not present in it."""


class _UnixHTTPConnection(http.client.HTTPConnection):
    """HTTP over an ``AF_UNIX`` stream socket (the Docker Engine transport)."""

    def __init__(self, socket_path: str, timeout: float = 10.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


def _connect(host: str) -> http.client.HTTPConnection:
    """``host`` is a unix socket path or a ``tcp://addr:port`` URL
    (``DOCKER_HOST`` syntax)."""
    if host.startswith("tcp://") or host.startswith("http://"):
        u = urllib.parse.urlparse(host)
        return http.client.HTTPConnection(u.hostname, u.port or 2375, timeout=10)
    if host.startswith("unix://"):
        host = host[len("unix://") :]
    return _UnixHTTPConnection(host)


class DockerDaemonSource:
    """Docker-Engine-API image source; also serves podman (same API).

    ``export_to(path)`` writes the ``docker save`` tarball for the ref;
    the caller feeds it to the archive loader.
    """

    api = "docker"

    def __init__(self, ref: str, host: str):
        self.ref = ref
        self.host = host

    def _request(self, method: str, path: str):
        conn = _connect(self.host)
        try:
            conn.request(method, path, headers={"Host": "docker"})
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise DaemonError(f"{self.api} daemon at {self.host}: {e}") from e
        if resp.status == 404:
            resp.read()
            conn.close()
            raise DaemonError(
                f"image {self.ref!r} not found in {self.api} daemon"
            )
        if resp.status >= 400:
            body = resp.read(4096)
            conn.close()
            raise DaemonError(
                f"{self.api} daemon {method} {path}: HTTP {resp.status}: "
                f"{body[:200]!r}"
            )
        return conn, resp

    def ping(self) -> bool:
        try:
            conn, resp = self._request("GET", "/_ping")
        except DaemonError:
            return False
        resp.read()
        conn.close()
        return True

    def inspect(self) -> dict:
        """``GET /images/{ref}/json`` — ID + config for the report."""
        quoted = urllib.parse.quote(self.ref, safe="")
        conn, resp = self._request("GET", f"/images/{quoted}/json")
        try:
            return json.loads(resp.read())
        finally:
            conn.close()

    def export_to(self, path: str) -> None:
        """``GET /images/{ref}/get`` — stream the save-tarball to ``path``."""
        quoted = urllib.parse.quote(self.ref, safe="")
        conn, resp = self._request("GET", f"/images/{quoted}/get")
        try:
            with open(path, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
        finally:
            conn.close()


class ContainerdSource:
    """Detection-only seam: containerd speaks gRPC, which this build does
    not (see module docstring)."""

    api = "containerd"

    def __init__(self, ref: str, host: str):
        self.ref = ref
        self.host = host

    def export_to(self, path: str) -> None:
        raise DaemonError(
            f"containerd socket {self.host} found, but its gRPC API is not "
            "supported in this build; export the image with "
            f"`ctr images export img.tar {self.ref}` and scan the archive, "
            "or use the docker/podman/remote sources"
        )


def _podman_sockets() -> list[str]:
    xdg = os.environ.get("XDG_RUNTIME_DIR", f"/run/user/{os.getuid()}")
    return [p.format(xdg=xdg) for p in PODMAN_SOCKETS]


def _first_socket(paths: list[str]) -> str | None:
    for p in paths:
        if os.path.exists(p):
            return p
    return None


def resolve_daemon_source(ref: str, image_src: list[str], option=None):
    """First available daemon holding ``ref``, in ``image_src`` order —
    the resolution walk of pkg/fanal/image/image.go:27-58. Returns None
    when no daemon source applies (caller falls through to the registry).
    """
    explicit_host = getattr(option, "docker_host", "") or os.environ.get(
        "DOCKER_HOST", ""
    )
    errors: list[str] = []
    for src in image_src:
        if src == "docker":
            host = explicit_host or _first_socket(DOCKER_SOCKETS)
            if not host:
                continue
            cand = DockerDaemonSource(ref, host)
        elif src == "podman":
            host = getattr(option, "podman_host", "") or _first_socket(
                _podman_sockets()
            )
            if not host:
                continue
            cand = DockerDaemonSource(ref, host)
            cand.api = "podman"
        elif src == "containerd":
            host = getattr(option, "containerd_host", "") or _first_socket(
                CONTAINERD_SOCKETS
            )
            if not host:
                continue
            # a containerd socket existing must not block the walk (it is
            # present on every docker/k8s host): only an *explicit*
            # containerd-only request surfaces its unsupported-API error
            if image_src == ["containerd"]:
                return ContainerdSource(ref, host)
            errors.append(
                f"containerd socket {host} skipped (gRPC API unsupported)"
            )
            continue
        else:  # "remote" and unknown ids are the registry's problem
            continue
        try:
            cand.inspect()
            return cand
        except DaemonError as e:
            errors.append(str(e))
            continue
    if errors:
        logger.debug("daemon sources skipped: %s", "; ".join(errors))
    return None


def export_to_tempfile(source) -> str:
    """Export the daemon image to a temp archive; caller owns the file."""
    fd, path = tempfile.mkstemp(suffix=".tar", prefix="trivy-tpu-daemon-")
    os.close(fd)
    try:
        source.export_to(path)
    except BaseException:
        os.unlink(path)
        raise
    return path
