"""Java DB: JAR digest → Maven coordinates.

The reference resolves JAR identities by sha1 against trivy-java-db, an
OCI-distributed index (ref: pkg/javadb/client.go:24-47; the jar parser
feeds digests at pkg/dependency/parser/java/jar/parse.go). This build has
no egress, so the DB loads from a local directory:

    <dir>/metadata.json          {"Version": 1, ...}        (optional)
    <dir>/index.json             {"<sha1 hex>": "group:artifact:version", ...}

The jar analyzer consults it when configured (``--java-db`` /
``java_db_path`` analyzer option); without it, filename parsing remains
the fallback lane.
"""

from __future__ import annotations

import hashlib
import json
import os

from trivy_tpu_torch import log

logger = log.logger("javadb")


class JavaDB:
    def __init__(self, by_sha1: dict[str, str], metadata: dict | None = None):
        self.by_sha1 = by_sha1
        self.metadata = metadata or {}

    @classmethod
    def load(cls, db_dir: str) -> "JavaDB | None":
        index_path = os.path.join(db_dir, "index.json")
        if not os.path.exists(index_path):
            logger.warning("java DB index not found at %s", index_path)
            return None
        try:
            with open(index_path, encoding="utf-8") as f:
                by_sha1 = json.load(f)
            if not isinstance(by_sha1, dict):
                raise ValueError("index.json is not an object")
        except (OSError, ValueError) as e:
            # a broken DB degrades to the filename lane, never kills the scan
            logger.warning("java DB at %s unusable: %s", db_dir, e)
            return None
        meta = {}
        meta_path = os.path.join(db_dir, "metadata.json")
        try:
            if os.path.exists(meta_path):
                with open(meta_path, encoding="utf-8") as f:
                    meta = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("java DB metadata unreadable: %s", e)
        logger.debug("java DB: %d jar digests", len(by_sha1))
        return cls(by_sha1, meta)

    def lookup_sha1(self, sha1_hex: str) -> tuple[str, str, str] | None:
        """sha1 → (group, artifact, version)."""
        gav = self.by_sha1.get(sha1_hex)
        if not gav:
            return None
        parts = gav.split(":")
        if len(parts) != 3:
            return None
        return parts[0], parts[1], parts[2]

    def lookup_content(self, content: bytes) -> tuple[str, str, str] | None:
        return self.lookup_sha1(hashlib.sha1(content).hexdigest())
