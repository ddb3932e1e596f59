"""IaC adapters: evaluated config blocks → typed provider state
(ref: pkg/iac/adapters — independent, deliberately leaner implementation).

The port of ``trivy_tpu/misconf/adapters/__init__.py``.
"""
