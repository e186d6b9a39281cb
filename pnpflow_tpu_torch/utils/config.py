"""Config system with the reference CLI's public surface.

A copy of ``pnpflow_tpu/utils/config.py``: a dict-subclass ``CfgNode`` with
attribute access, a flattened-YAML loader (every top-level section's keys are
hoisted to the root), and a ``--opts key value ...`` override list whose
values are coerced with ``ast.literal_eval`` and type-checked against the
existing value (tuple<->list casts allowed, unknown keys silently added).

The config files are flat two-level YAML (``SECTION:`` then indented
``key: scalar`` lines).  They are read by :func:`read_flat_yaml`, a small
reader for exactly that subset, so the port needs no YAML package; it agrees
with ``yaml.safe_load`` on every file under ``config/``.
"""

from __future__ import annotations

import copy
import os
import re
from ast import literal_eval
from typing import List


class CfgNode(dict):
    """Dict-like config node with attribute-style access."""

    def __init__(self, init_dict=None, key_list=None):
        init_dict = {} if init_dict is None else init_dict
        key_list = [] if key_list is None else key_list
        for k, v in init_dict.items():
            if type(v) is dict:
                init_dict[k] = CfgNode(v, key_list=key_list + [k])
        super().__init__(init_dict)

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __str__(self):
        lines = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.extend("  " + sub for sub in str(v).split("\n"))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self):
        return "{}({})".format(type(self).__name__, super().__repr__())


# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader applies it
_BOOL = {
    "yes": True, "Yes": True, "YES": True, "no": False, "No": False,
    "NO": False, "true": True, "True": True, "TRUE": True, "false": False,
    "False": False, "FALSE": False, "on": True, "On": True, "ON": True,
    "off": False, "Off": False, "OFF": False,
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|[-+]?\.(inf|Inf|INF)$|\.(nan|NaN|NAN)$"
)


def _scalar(text: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        low = text.lower().replace("_", "")
        if low.endswith(".inf"):
            return float(low.replace(".inf", "inf"))
        if low == ".nan":
            return float("nan")
        return float(low)
    return text


def _strip_comment(line: str) -> str:
    """Drop a `` #`` comment that is outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_flat_yaml(path: str) -> dict:
    """Parse ``SECTION:`` / indented ``key: scalar`` YAML into nested dicts.

    Raises ``ValueError`` on anything outside that subset (lists, nested
    mappings, multi-line scalars), so a config the reader cannot represent
    fails loudly instead of loading wrong.
    """
    out: dict = {}
    section = None
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            indented = line[0] in " \t"
            key, sep, value = line.strip().partition(":")
            if not sep or (value and value[0] not in " \t"):
                raise ValueError(f"{path}:{lineno}: unsupported YAML: {raw!r}")
            value = value.strip()
            if not indented:
                if value:
                    raise ValueError(
                        f"{path}:{lineno}: top level must be sections")
                section = out.setdefault(key, {})
            elif (section is None or value[:1] in ("[", "{", "|", ">")
                  or value == "-" or value.startswith("- ")):
                raise ValueError(f"{path}:{lineno}: unsupported YAML: {raw!r}")
            else:
                section[key] = _scalar(value)
    return out


def _decode_cfg_value(v):
    """Best-effort literal_eval of a CLI string."""
    if not isinstance(v, str):
        return v
    try:
        v = literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    return v


def _coerce_cfg_value_type(replacement, original, full_key):
    """Require matching types, allowing tuple<->list casts."""
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type:
        return replacement
    for from_type, to_type in [(tuple, list), (list, tuple)]:
        if replacement_type == from_type and original_type == to_type:
            return to_type(replacement)
    raise ValueError(
        f"config key {full_key!r}: cannot override value {original!r} of "
        f"type {original_type.__name__} with {replacement!r} of type "
        f"{replacement_type.__name__}"
    )


def load_cfg_from_cfg_file(file: str) -> CfgNode:
    """Load a YAML whose single-level sections are flattened to the root."""
    if not (os.path.isfile(file) and file.endswith(".yaml")):
        raise FileNotFoundError("{} is not a yaml file".format(file))
    cfg = {}
    for section in read_flat_yaml(file).values():
        cfg.update(section)
    return CfgNode(cfg)


def merge_cfg_from_list(cfg: CfgNode, cfg_list: List[str]) -> CfgNode:
    """Merge ``--opts k v k v ...`` overrides.

    Known keys are type-coerced against the current value; unknown keys are
    added verbatim (after literal_eval).
    """
    if len(cfg_list) % 2:
        raise ValueError("--opts needs key value pairs: {}".format(cfg_list))
    new_cfg = copy.deepcopy(cfg)
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        subkey = full_key.split(".")[-1]
        value = _decode_cfg_value(v)
        if subkey in cfg:
            value = _coerce_cfg_value_type(value, cfg[subkey], full_key)
        setattr(new_cfg, subkey, value)
    return new_cfg


def load_full_config(opts: List[str] | None, root: str = "./") -> CfgNode:
    """Three-tier config resolution: main -> dataset -> method, with CLI
    overrides applied both before tier 2/3 selection and again at the end;
    the method-file keys are captured in ``cfg.dict_cfg_method``
    (post-override values) for result-dir naming."""
    cfg = load_cfg_from_cfg_file(os.path.join(root, "config/main_config.yaml"))
    if opts:
        cfg = merge_cfg_from_list(cfg, opts)

    dataset_config = os.path.join(
        cfg.root, "config/dataset_config/{}.yaml".format(cfg.dataset)
    )
    cfg.update(load_cfg_from_cfg_file(dataset_config))

    method_config_file = os.path.join(
        cfg.root, "config/method_config/{}.yaml".format(cfg.method)
    )
    cfg.update(load_cfg_from_cfg_file(method_config_file))

    if opts:
        cfg = merge_cfg_from_list(cfg, opts)

    method_cfg = load_cfg_from_cfg_file(method_config_file)
    cfg.dict_cfg_method = {}
    for key in method_cfg.keys():
        cfg.dict_cfg_method[key] = cfg[key]
    return cfg


def get_save_path_ip(dict_cfg_method) -> str:
    """key1=value1/key2=value2/... result-dir component."""
    path = ""
    for key, value in dict_cfg_method.items():
        path = os.path.join(path, "{}={}".format(key, value))
    return path
