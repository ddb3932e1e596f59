"""OCI Distribution (registry v2) image source, the port's copy of
``trivy_tpu/fanal/image_registry.py`` (ref: pkg/fanal/image/image.go:27-58
resolution order and pkg/fanal/image/registry/token.go auth; the reference
tests this against a local in-process registry,
pkg/fanal/test/integration, as tests/test_torch_registry.py does).

Implements the pull side of the distribution spec with urllib:

- ``GET /v2/`` ping (and 401 challenge discovery)
- Bearer token auth: parse ``WWW-Authenticate: Bearer realm=...``, fetch
  the token with service+scope (+ optional basic credentials), retry
- manifest pull with Accept headers for OCI/Docker manifests and indexes
  (``--platform`` picks an index entry, else the first runnable one)
- blob pull with sha256 digest verification

:class:`RegistryImage` has the surface of the image artifact's archive
reader (``image_id``, ``diff_ids``, ``layer_stream``, ``layer_size``,
``layer_history``, ``config``), so a pulled image runs the archive's layer
pipeline and cache keys.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import re
import urllib.error
import urllib.parse
import urllib.request

from trivy_tpu_torch import log

logger = log.logger("image:registry")

MANIFEST_ACCEPT = ", ".join([
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.oci.image.index.v1+json",
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
])


class RegistryError(Exception):
    pass


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None  # surface 30x to the caller for header-stripped retry


_OPENER = urllib.request.build_opener(_NoRedirect)


def parse_image_ref(ref: str) -> tuple[str, str, str]:
    """``host[:port]/repo[:tag][@digest]`` -> (registry, repository, ref).

    Follows docker reference rules: the first path component is a registry
    host only when it contains a dot, a colon, or is ``localhost``;
    otherwise the whole name is a Docker-Hub-style repository (which this
    build cannot reach — zero egress — so the caller errors out usefully).
    """
    if "@" in ref:
        name, _, digest = ref.partition("@")
        tag = digest
        # name:tag@digest (kubectl-rendered form): the digest wins and the
        # tag must not stay inside the repository path
        head, _, tail = name.rpartition(":")
        if head and "/" not in tail:
            name = head
    else:
        name = ref
        tag = ""
        # split a possible :tag (not the registry :port)
        head, _, tail = ref.rpartition(":")
        if head and "/" not in tail:
            name, tag = head, tail
    parts = name.split("/")
    if len(parts) > 1 and (
        "." in parts[0] or ":" in parts[0] or parts[0] == "localhost"
    ):
        registry = parts[0]
        repository = "/".join(parts[1:])
        if registry in ("docker.io", "index.docker.io"):
            # Docker Hub's v2 API host differs from its reference name
            registry = "registry-1.docker.io"
            if "/" not in repository:
                repository = f"library/{repository}"
    else:
        registry = "registry-1.docker.io"
        repository = name if "/" in name else f"library/{name}"
    return registry, repository, tag or "latest"


class RegistryClient:
    """Minimal distribution-spec pull client with bearer/basic auth."""

    def __init__(
        self,
        registry: str,
        insecure: bool = False,
        username: str = "",
        password: str = "",
    ):
        self.registry = registry
        self.scheme = "http" if insecure else "https"
        self.username = username
        self.password = password
        self._token: str | None = None

    def _url(self, path: str) -> str:
        return f"{self.scheme}://{self.registry}{path}"

    def _basic_header(self) -> str:
        import base64

        raw = f"{self.username}:{self.password}".encode()
        return "Basic " + base64.b64encode(raw).decode()

    def _open(self, path: str, accept: str = ""):
        """GET with one token-challenge retry; returns the open response."""
        for attempt in (0, 1):
            req = urllib.request.Request(self._url(path))
            if accept:
                req.add_header("Accept", accept)
            if self._token:
                req.add_header("Authorization", f"Bearer {self._token}")
            elif self.username:
                req.add_header("Authorization", self._basic_header())
            try:
                return _OPENER.open(req, timeout=30)
            except urllib.error.HTTPError as e:
                if e.code in (301, 302, 303, 307, 308):
                    # follow manually WITHOUT auth headers: presigned CDN
                    # URLs (S3/GCS) reject requests that carry both a query
                    # signature and an Authorization header
                    loc = e.headers.get("Location", "")
                    if loc:
                        try:
                            return urllib.request.urlopen(
                                urllib.request.Request(loc), timeout=60
                            )
                        except urllib.error.URLError as e2:
                            raise RegistryError(
                                f"redirected blob fetch failed: {e2}"
                            ) from e2
                if e.code == 401 and attempt == 0:
                    challenge = e.headers.get("WWW-Authenticate", "")
                    if challenge.lower().startswith("bearer"):
                        self._fetch_token(challenge)
                        continue
                raise RegistryError(
                    f"registry {self.registry} returned {e.code} for {path}"
                ) from e
            except urllib.error.URLError as e:
                raise RegistryError(
                    f"cannot reach registry {self.registry}: {e.reason}"
                ) from e
        raise RegistryError(f"authorization failed for {path}")

    def _request(self, path: str, accept: str = "") -> tuple[bytes, dict]:
        with self._open(path, accept) as resp:
            return resp.read(), dict(resp.headers)

    def _fetch_token(self, challenge: str) -> None:
        """Bearer challenge -> token endpoint round trip
        (ref: pkg/fanal/image/registry token flow)."""
        fields = dict(
            re.findall(r'(\w+)="([^"]*)"', challenge.partition(" ")[2])
        )
        realm = fields.get("realm")
        if not realm:
            raise RegistryError(f"unparseable auth challenge: {challenge!r}")
        query = {}
        if fields.get("service"):
            query["service"] = fields["service"]
        if fields.get("scope"):
            query["scope"] = fields["scope"]
        url = realm + ("?" + urllib.parse.urlencode(query) if query else "")
        req = urllib.request.Request(url)
        if self.username:
            req.add_header("Authorization", self._basic_header())
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                doc = json.loads(resp.read())
        except (urllib.error.URLError, json.JSONDecodeError) as e:
            raise RegistryError(f"token fetch from {realm} failed: {e}") from e
        self._token = doc.get("token") or doc.get("access_token")
        if not self._token:
            raise RegistryError("token endpoint returned no token")

    # -- API ------------------------------------------------------------------

    def manifest(self, repository: str, reference: str) -> dict:
        body, headers = self._request(
            f"/v2/{repository}/manifests/{reference}", accept=MANIFEST_ACCEPT
        )
        if reference.startswith("sha256:"):
            got = "sha256:" + hashlib.sha256(body).hexdigest()
            if got != reference:
                raise RegistryError(
                    f"manifest digest mismatch: want {reference}, got {got}"
                )
        return json.loads(body)

    def blob(self, repository: str, digest: str) -> bytes:
        body, _ = self._request(f"/v2/{repository}/blobs/{digest}")
        algo, _, hexd = digest.partition(":")
        if algo == "sha256":
            got = hashlib.sha256(body).hexdigest()
            if got != hexd:
                raise RegistryError(
                    f"blob digest mismatch: want {hexd}, got {got}"
                )
        return body

    def blob_file(self, repository: str, digest: str):
        """Blob streamed to a spooled temp file (memory-bounded: multi-GB
        layers never sit fully in RAM), hash-verified, seeked to 0."""
        import tempfile

        resp = self._open(f"/v2/{repository}/blobs/{digest}")
        h = hashlib.sha256()
        spool = tempfile.SpooledTemporaryFile(max_size=32 * 1024 * 1024)
        try:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                spool.write(chunk)
        finally:
            resp.close()
        algo, _, hexd = digest.partition(":")
        if algo == "sha256" and h.hexdigest() != hexd:
            spool.close()
            raise RegistryError(
                f"blob digest mismatch: want {hexd}, got {h.hexdigest()}"
            )
        spool.seek(0)
        return spool


class RegistryImage:
    """Image pulled from a registry, presenting the archive-source surface
    the image artifact pipeline consumes (image_id / diff_ids /
    layer_stream / layer_history / config)."""

    def __init__(
        self,
        ref: str,
        insecure: bool = False,
        username: str = "",
        password: str = "",
        platform: str = "",
    ):
        registry, repository, reference = parse_image_ref(ref)
        self.name = ref
        self.repository = repository
        self.client = RegistryClient(
            registry, insecure=insecure, username=username, password=password
        )
        manifest = self.client.manifest(repository, reference)
        # image index: pick the requested platform, else the first image
        while "manifests" in manifest:
            # attestation/unknown entries are not runnable images
            entries = [
                e for e in manifest["manifests"]
                if (e.get("platform") or {}).get("os") != "unknown"
            ] or manifest["manifests"]
            if not entries:
                raise RegistryError(f"image index for {ref} lists no manifests")
            chosen = None
            if platform:
                want_os, _, want_arch = platform.partition("/")
                for e in entries:
                    p = e.get("platform", {})
                    if p.get("os") == want_os and (
                        not want_arch or p.get("architecture") == want_arch
                    ):
                        chosen = e
                        break
                if chosen is None:
                    avail = ", ".join(
                        f"{(e.get('platform') or {}).get('os', '?')}/"
                        f"{(e.get('platform') or {}).get('architecture', '?')}"
                        for e in entries
                    )
                    raise RegistryError(
                        f"no {platform} image in index for {ref} "
                        f"(available: {avail})"
                    )
            if chosen is None:
                chosen = entries[0]
            manifest = self.client.manifest(repository, chosen["digest"])
        self.manifest = manifest
        self.config_bytes = self.client.blob(
            repository, manifest["config"]["digest"]
        )
        self.config = json.loads(self.config_bytes)
        self._layers = manifest["layers"]

    def close(self) -> None:
        pass

    @property
    def image_id(self) -> str:
        return f"sha256:{hashlib.sha256(self.config_bytes).hexdigest()}"

    @property
    def diff_ids(self) -> list[str]:
        return list(self.config.get("rootfs", {}).get("diff_ids", []))

    def layer_stream(self, index: int):
        """Readable stream of layer ``index``'s tar (gzip layers
        decompressed), spooled from the registry with its digest checked;
        closing it (it is a context manager) frees the spool."""
        desc = self._layers[index]
        mt = desc.get("mediaType", "")
        if mt.endswith("zstd"):
            raise RegistryError(
                f"layer {desc['digest']} uses zstd compression, which this "
                "build cannot decompress; re-push the image with gzip layers"
            )
        spool = self.client.blob_file(self.repository, desc["digest"])
        if mt.endswith(("gzip", "gzip+encrypted")):
            return _GzipSpool(spool)
        return spool

    def layer_size(self, index: int) -> int:
        """Stored (for gzip layers, compressed) byte size of layer
        ``index``, from its manifest descriptor."""
        return int(self._layers[index].get("size", 0))

    def layer_history(self) -> list[dict]:
        return [
            h for h in self.config.get("history", []) if not h.get("empty_layer")
        ]


class _GzipSpool(gzip.GzipFile):
    """A gzip stream over a spooled blob that frees the spool on close."""

    def __init__(self, spool):
        super().__init__(fileobj=spool, mode="rb")
        self._spool = spool

    def close(self) -> None:
        try:
            super().close()
        finally:
            self._spool.close()
