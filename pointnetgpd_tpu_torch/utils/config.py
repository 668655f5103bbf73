"""YAML config loader (the autolab_core.YamlConfig equivalent). A copy of
``pointnetgpd_tpu/utils/config.py``.

(reference: configs are loaded via autolab_core.YamlConfig throughout —
generate-dataset-canny.py:153, kinect2grasp's yaml_config, api defaults.)
Dict-like access with attribute sugar and file round-trip; no external
dependency beyond PyYAML when available (falls back to a minimal parser for
the flat/nested mapping subset the reference configs use).
"""

from __future__ import annotations

import json


class YamlConfig(dict):
    """dict with attribute access + .save(); construct from a path or dict."""

    def __init__(self, source=None):
        super().__init__()
        if isinstance(source, str):
            self.update(_load_yaml(source))
            self._path = source
        elif isinstance(source, dict):
            self.update(source)
            self._path = None

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def save(self, path: str | None = None):
        path = path or self._path
        try:
            import yaml

            with open(path, "w") as f:
                yaml.safe_dump(dict(self), f)
        except ImportError:
            with open(path, "w") as f:
                json.dump(dict(self), f, indent=2)


def _load_yaml(path: str) -> dict:
    try:
        import yaml

        with open(path) as f:
            return yaml.safe_load(f) or {}
    except ImportError:
        return _mini_yaml(path)


def _coerce(v: str):
    v = v.strip()
    if v in ("", "~", "null"):
        return None
    for lit, val in (("true", True), ("false", False),
                     ("True", True), ("False", False)):
        if v == lit:
            return val
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [_coerce(x) for x in inner.split(",")] if inner else []
    return v.strip("'\"")


def _mini_yaml(path: str) -> dict:
    """Minimal indentation-based mapping parser (comments, scalars, lists of
    scalars) — enough for the reference's config files."""
    root: dict = {}
    stack = [(-1, root)]
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip())
            key, _, rest = line.strip().partition(":")
            while stack and indent <= stack[-1][0]:
                stack.pop()
            parent = stack[-1][1]
            if rest.strip():
                parent[key] = _coerce(rest)
            else:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
    return root
