"""config.yaml-compatible configuration, read without PyYAML.

Same dataclasses, keys and engine defaults as the reference package's
`io/config.py`. `parse_yaml` reads the subset of YAML that config.yaml
uses: nested block mappings, block sequences of scalars, plain and quoted
scalars, `[a, b]` flow lists and `#` comments. Scalars resolve as PyYAML's
`safe_load` resolves them (YAML 1.1 booleans and null, ints, floats that
carry a dot), so a file in that subset gives the same dict.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import List

_FLOAT = re.compile(
    r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$"
)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(s: str) -> List[str]:
    items, cur, quote = [], "", None
    for ch in s:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur.strip())
    return items


def _scalar(s: str):
    s = s.strip()
    if s.startswith("[") and s.endswith("]"):
        return [_scalar(t) for t in _split_flow(s[1:-1])]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body.encode().decode("unicode_escape")
    low = s.lower()
    if s in ("", "~") or low == "null":
        return None
    if low in _BOOL and s in (low, low.capitalize(), low.upper()):
        return _BOOL[low]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    return s


def parse_yaml(text: str):
    """Parse the block-mapping subset of YAML described in the module doc."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = _strip_comment(raw)
        if body.strip():
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))

    def block(i: int, indent: int):
        if lines[i][1].startswith("- "):
            out = []
            while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("- "):
                out.append(_scalar(lines[i][1][2:]))
                i += 1
            return out, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            text_ = lines[i][1]
            key, sep, rest = text_.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise ValueError(f"unsupported YAML line: {text_!r}")
            key = _scalar(key)
            rest = rest.strip()
            i += 1
            if rest:
                out[key] = _scalar(rest)
            elif i < len(lines) and (lines[i][0] > indent or (
                    lines[i][0] == indent and lines[i][1].startswith("- "))):
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    if not lines:
        return None
    data, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unsupported YAML structure near: {lines[i][1]!r}")
    return data


@dataclasses.dataclass
class MpcSection:
    horizon: int
    dt: float
    physics_dt: float
    gravity: List[float]
    sim_steps: int
    contact_impratio: float
    cost_weights: dict
    constraints: dict


@dataclasses.dataclass
class AppConfig:
    model_path: str
    urdf_path: str
    ee_feet: dict
    q_ref_path: str
    v_ref_path: str
    contact_schedule_path: str
    mpc: MpcSection
    logs_dir: str
    results_dir: str
    verbose: bool
    save_trajectories: bool
    results_path: str
    engine: dict  # engine extras (defaults applied)
    root: str  # directory paths are resolved against

    def resolve(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.root, p)


_ENGINE_DEFAULTS = dict(
    cost_mode="reference",
    line_search="first_accept",
    contact_stiffness=3.0e4,
    contact_damping=3.0e3,
    contact_friction=1.0,
    max_iterations=10,
    tolerance=1e-4,
    dtype="float32",
    backward="scan",
    linearization="ad",
    quad_mode="exact",
    scan_unroll=1,
    quat_tangent=False,
)


def load_config(path: str = "config.yaml") -> AppConfig:
    with open(path) as f:
        y = parse_yaml(f.read())

    mpc = y["mpc"]
    engine = dict(_ENGINE_DEFAULTS)
    engine.update(y.get("engine", {}) or {})
    return AppConfig(
        model_path=y["robot"]["model_path"],
        urdf_path=y["robot"].get("urdf_path", ""),
        ee_feet=y["robot"].get(
            "ee_feet",
            {"right_feet_ee": "right_ankle_link", "left_feet_ee": "left_ankle_link"},
        ),
        q_ref_path=y["reference_trajectory"]["q_ref"],
        v_ref_path=y["reference_trajectory"]["v_ref"],
        contact_schedule_path=y["reference_trajectory"]["contact_schedule"],
        mpc=MpcSection(
            horizon=int(mpc["horizon"]),
            dt=float(mpc["dt"]),
            physics_dt=float(mpc["physics_dt"]),
            gravity=[float(g) for g in mpc["gravity"]],
            sim_steps=int(mpc["sim_steps"]),
            contact_impratio=float(mpc.get("contact_impratio", 100.0)),
            cost_weights=mpc["cost_weights"],
            constraints=mpc["constraints"],
        ),
        logs_dir=y.get("paths", {}).get("logs_dir", "logs"),
        results_dir=y.get("paths", {}).get("results_dir", "results"),
        verbose=bool(y["logging"]["verbose"]),
        save_trajectories=bool(y["logging"]["save_trajectories"]),
        results_path=y["logging"].get("results_path", "results"),
        engine=engine,
        root=os.path.dirname(os.path.abspath(path)),
    )
