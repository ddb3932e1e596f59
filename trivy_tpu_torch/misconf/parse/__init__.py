"""IaC parsers: typed inputs for the check engine (the port of
``trivy_tpu/misconf/parse/``)."""
