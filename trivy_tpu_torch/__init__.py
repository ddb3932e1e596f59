"""PyTorch/CUDA port of trivy_tpu for NVIDIA Hopper.

A package of its own beside ``trivy_tpu`` (the JAX reference): it imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``trivy_tpu``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

VERSION = "0.1.0"  # the JAX CLI's version (trivy_tpu/cli.py), kept apart
