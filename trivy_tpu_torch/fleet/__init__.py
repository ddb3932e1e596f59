"""The port's fleet package. It holds only the directory-atomic unit
planner (``plan.py::group_units``), which the incremental fs artifact
(``trivy_tpu_torch/incremental/fs.py``) shares with the JAX fleet's shard
planner. The fleet itself (shard planning and execution, the coordinator,
the merge, the telemetry plane and the ``--fleet`` flag group) is not
ported yet: its flags exit 2 as every JAX flag the port lacks does."""
