"""Artifacts of the port that are more than one tree: image archives
(``image.py``)."""
