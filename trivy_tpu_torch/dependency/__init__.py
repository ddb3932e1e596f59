"""Lockfile and manifest parsers (the port's copy of ``trivy_tpu/dependency``)."""
