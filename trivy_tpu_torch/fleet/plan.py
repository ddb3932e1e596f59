"""Directory-atomic unit planning, the port's copy of
``trivy_tpu/fleet/plan.py::group_units``.

The incremental fs artifact keys, caches and analyzes a tree unit by unit
over these units; the applier merges their blobs back into the one-blob
scan's findings. The rest of the JAX planner (shard planning, the wire
form of a shard, ``execute_shard`` on a replica) comes with the fleet.
"""

from __future__ import annotations


def group_units(files: list[tuple[str, int]]) -> list[tuple[str, list, int]]:
    """Directory-atomic unit grouping over ``[(rel, size), ...]``.

    Each unit is ``(unit_key, [(rel, size), ...], bytes)``, in the order of
    their keys, each unit's files sorted. A directory holding
    ``Chart.yaml`` pulls its whole subtree into one unit (a Helm chart is
    evaluated as a whole), the nearest enclosing chart winning; every other
    directory is its own unit, so sibling files (a manifest and its
    lockfile) stay together."""
    by_dir: dict[str, list[tuple[str, int]]] = {}
    chart_roots: list[str] = []
    for rel, size in files:
        d = rel.rsplit("/", 1)[0] if "/" in rel else ""
        by_dir.setdefault(d, []).append((rel, size))
        if rel.rsplit("/", 1)[-1] == "Chart.yaml":
            chart_roots.append(d)
    chart_roots.sort(key=len, reverse=True)

    def unit_for(d: str) -> str:
        for cr in chart_roots:  # longest (nearest enclosing) chart first
            if cr == "":
                return ""
            if d == cr or d.startswith(cr + "/"):
                return cr
        return d

    units_map: dict[str, list[tuple[str, int]]] = {}
    for d, entries in by_dir.items():
        units_map.setdefault(unit_for(d), []).extend(entries)
    units = []
    for key in sorted(units_map):
        entries = sorted(units_map[key])
        units.append((key, entries, sum(s for _, s in entries)))
    return units
