"""Artifacts of the port that are more than one tree: images from archives,
registries and daemons (``image.py``), disk images (``vm.py``), and the git
checkout a ``repo`` scan walks (``repo.py``)."""
