"""Line-tracking YAML/JSON loader (the port of
``trivy_tpu/misconf/parse/yamljson.py``).

Checks must report CauseMetadata start/end lines (ref: the rego engine gets
them from file positions captured at parse time). PyYAML's composer exposes
node marks; we build plain dict/list structures in ``LMap``/``LSeq``
subclasses that carry per-node and per-key line spans. JSON files are loaded
through the same YAML path (YAML is a superset for the JSON subset we care
about), giving JSON line numbers for free.
"""

from __future__ import annotations

import yaml


class LMap(dict):
    """dict with .span = (start, end) and .key_spans[key] = (start, end)."""

    __slots__ = ("span", "key_spans")

    def __init__(self):
        super().__init__()
        self.span = (0, 0)
        self.key_spans = {}

    def line(self, key, default: int = 0) -> int:
        return self.key_spans.get(key, (default, default))[0]


class LSeq(list):
    __slots__ = ("span",)

    def __init__(self):
        super().__init__()
        self.span = (0, 0)


def _span(node) -> tuple[int, int]:
    # end_mark points one past the node; clamp multi-line scalars sensibly
    start = node.start_mark.line + 1
    end = node.end_mark.line + 1
    if node.end_mark.column == 0:
        end -= 1
    return (start, max(start, end))


def _construct(node, loader):
    # custom-tagged nodes (e.g. CloudFormation !Ref/!If) dispatch to the
    # loader's registered constructor rather than the structural path
    if node.tag and not node.tag.startswith("tag:yaml.org,2002:"):
        return loader.construct_object(node, deep=True)
    if isinstance(node, yaml.MappingNode):
        out = LMap()
        out.span = _span(node)
        for knode, vnode in node.value:
            key = loader.construct_object(knode, deep=True)
            try:
                out[key] = _construct(vnode, loader)
            except TypeError:  # unhashable key; fall back to string form
                out[str(key)] = _construct(vnode, loader)
            ks, _ = _span(knode)
            _, ve = _span(vnode)
            try:
                out.key_spans[key] = (ks, max(ks, ve))
            except TypeError:
                out.key_spans[str(key)] = (ks, max(ks, ve))
        return out
    if isinstance(node, yaml.SequenceNode):
        out = LSeq()
        out.span = _span(node)
        out.extend(_construct(v, loader) for v in node.value)
        return out
    return loader.construct_object(node, deep=True)


_tolerant_cls = None


def tolerant_loader_cls():
    """SafeLoader subclass mapping unknown tags (``!reference``, vendor
    extensions) to their plain node values — detection and parsing must
    agree on which files are loadable."""
    global _tolerant_cls
    if _tolerant_cls is None:

        class Loader(yaml.SafeLoader):
            pass

        def _any(loader, tag_suffix, node):
            if isinstance(node, yaml.ScalarNode):
                return loader.construct_scalar(node)
            if isinstance(node, yaml.SequenceNode):
                return loader.construct_sequence(node)
            return loader.construct_mapping(node)

        Loader.add_multi_constructor("!", _any)
        _tolerant_cls = Loader
    return _tolerant_cls


def load_all(content: bytes) -> list:
    """All YAML documents with line spans; raises on malformed input."""
    text = content.decode("utf-8", "replace")
    docs = []
    loader = tolerant_loader_cls()(text)
    try:
        while loader.check_node():
            node = loader.get_node()
            docs.append(_construct(node, loader))
    finally:
        loader.dispose()
    return docs


def span_of(obj, default: tuple[int, int] = (0, 0)) -> tuple[int, int]:
    if isinstance(obj, (LMap, LSeq)):
        return obj.span
    return default
