"""gvins.yaml configuration: accepted verbatim, reference unit conversions.

Parity: the reference parses the same file in three places (fusion_ros.cc:
67-97, ic_gvins.cc:51-144, tracking.cc:49-60) with unit conversions at parse
time (deg/sqrt(hr) -> rad/sqrt(s), deg/hr -> rad/s, mGal -> m/s^2, hr -> s).
This module is the single parse point; every consumer reads the dataclass.

A carried-over copy of ``ic_gvins_tpu/engine/config.py`` (any
``ic_gvins_tpu`` import pulls in jax). ``load_config`` reads the file with
this module's own parser of the YAML subset the reference's ``gvins.yaml``
uses, so no machine needs pyyaml; ``parse_config(dict)`` is unchanged.
"""

import dataclasses
import math
import re
from typing import List, Optional

D2R = math.pi / 180.0
NORMAL_GRAVITY = 9.80


@dataclasses.dataclass
class CameraConfig:
    intrinsic: List[float]          # fx, fy, cx, cy (, skew)
    distortion: List[float]         # k1, k2, p1, p2 (, k3)
    resolution: List[int]           # width, height
    q_b_c: List[float]              # x, y, z, w
    t_b_c: List[float]
    td_b_c: float = 0.0


@dataclasses.dataclass
class ImuModel:
    arw: float       # rad/sqrt(s)
    vrw: float       # m/s/sqrt(s)
    gbstd: float     # rad/s
    abstd: float     # m/s^2
    corrtime: float  # s


@dataclasses.dataclass
class OdometerConfig:
    """Wheel odometer (ODO/EARTH_ODO preintegration variants). SI units."""

    std: List[float] = dataclasses.field(default_factory=lambda: [0.1, 0.1, 0.1])
    srw: float = 1.0e-3                 # scale random walk [1/sqrt(s)] (from PPM/sqrt(Hz))
    abv: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    lodo: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclasses.dataclass
class GvinsConfig:
    outputpath: str = ""
    is_make_outputdir: bool = True
    initlength: int = 1
    imudatarate: float = 200.0
    iswithearth: bool = True
    antlever: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    imumodel: ImuModel = None
    isusegnssoutage: bool = False
    gnssoutagetime: float = 0.0
    gnssthreshold: float = 20.0
    is_use_visualization: bool = False
    track_check_histogram: bool = False
    track_min_parallax: float = 20.0
    track_max_interval: float = 0.5
    track_max_features: int = 200
    reprojection_error_std: float = 1.5
    optimize_windows_size: int = 10
    optimize_num_iterations: int = 20
    optimize_estimate_extrinsic: bool = True
    optimize_estimate_td: bool = True
    # wheel odometer (the reference hard-disables it, ic_gvins.cc:100-101;
    # this framework exposes the capability for odometer-equipped setups)
    isuseodo: bool = False
    odometer: Optional[OdometerConfig] = None
    cam0: Optional[CameraConfig] = None

    # framework-specific capacity knobs (absent from the reference yaml;
    # defaulted so reference configs run unchanged)
    node_slots: int = 24           # sliding-window time-node capacity
    landmark_slots: int = 512
    gnss_slots: int = 24
    reproj_slots: int = 2048
    preint_samples: int = 512      # max IMU samples per preintegration

    @property
    def imudatadt(self):
        return 1.0 / self.imudatarate


def integration_params_from_config(cfg: GvinsConfig, gravity=NORMAL_GRAVITY, device=None):
    """The IntegrationParams of ``cfg`` (``core.types.
    integration_params_from_config``, at the JAX package's import path;
    ``core.types`` is imported here, at the call)."""
    from ..core.types import integration_params_from_config

    return integration_params_from_config(cfg, gravity=gravity, device=device)


def load_config(path) -> GvinsConfig:
    with open(path, "r") as f:
        raw = parse_yaml(f.read(), name=str(path))
    return parse_config(raw)


def parse_config(raw: dict) -> GvinsConfig:
    cfg = GvinsConfig()
    simple = [
        "outputpath", "is_make_outputdir", "initlength", "imudatarate", "iswithearth",
        "antlever", "isusegnssoutage", "gnssoutagetime", "gnssthreshold",
        "is_use_visualization", "track_check_histogram", "track_min_parallax",
        "track_max_interval", "track_max_features", "reprojection_error_std",
        "optimize_windows_size", "optimize_num_iterations",
        "optimize_estimate_extrinsic", "optimize_estimate_td", "isuseodo",
        "node_slots", "landmark_slots", "gnss_slots", "reproj_slots", "preint_samples",
    ]
    for key in simple:
        if key in raw and raw[key] is not None:
            setattr(cfg, key, raw[key])

    # IMU noise: unit conversions as ic_gvins.cc:92-96
    m = raw.get("imumodel", {})
    cfg.imumodel = ImuModel(
        arw=m.get("arw", 0.1) * D2R / 60.0,
        vrw=m.get("vrw", 0.1) / 60.0,
        gbstd=m.get("gbstd", 50.0) * D2R / 3600.0,
        abstd=m.get("abstd", 50.0) * 1.0e-5,
        corrtime=m.get("corrtime", 1.0) * 3600.0,
    )

    if "odometer" in raw and raw["odometer"]:
        o = raw["odometer"]
        cfg.odometer = OdometerConfig(
            std=list(o.get("std", [0.1, 0.1, 0.1])),
            # yaml srw is PPM/sqrt(Hz) (integration_state.h:83)
            srw=float(o.get("srw", 1000.0)) * 1.0e-6,
            abv=[v * D2R for v in o.get("abv", [0.0, 0.0, 0.0])],  # deg -> rad
            lodo=list(o.get("lodo", [0.0, 0.0, 0.0])),
        )
    elif cfg.isuseodo:
        cfg.odometer = OdometerConfig()

    if "cam0" in raw and raw["cam0"]:
        c = raw["cam0"]
        cfg.cam0 = CameraConfig(
            intrinsic=list(c["intrinsic"]),
            distortion=list(c["distortion"]),
            resolution=list(c["resolution"]),
            q_b_c=list(c["q_b_c"]),
            t_b_c=list(c["t_b_c"]),
            td_b_c=float(c.get("td_b_c", 0.0)),
        )
    return cfg


# ---------------------------------------------------------------------------
# the YAML subset of gvins.yaml (SURVEY.md 5.6): top-level keys with scalars,
# flow lists and flow maps, one level of block maps, comments
# ---------------------------------------------------------------------------

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+|$)")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)(?:[eE][-+]?[0-9]+)?$")
_SPECIAL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False,
            "yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
            "on": True, "On": True, "ON": True, "off": False, "Off": False, "OFF": False,
            "~": None, "null": None, "Null": None, "NULL": None,
            ".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf, ".nan": math.nan}


class YamlSubsetError(ValueError):
    """A gvins.yaml line outside the subset this parser reads."""


def _strip_comment(text):
    """``text`` up to a '#' that starts a comment (at the start or after
    whitespace, outside quotes), right-stripped."""
    quote = None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(tok, where):
    """One plain or quoted scalar. Booleans and nulls as YAML 1.1 (pyyaml);
    numbers as yaml-cpp reads them, so ``1e-5`` is a float (pyyaml's YAML
    1.1 resolver would keep it a string)."""
    if not tok:
        return None
    if tok[0] in "\"'":
        q = tok[0]
        if len(tok) < 2 or tok[-1] != q:
            raise YamlSubsetError(f"{where}: unterminated quoted string {tok!r}")
        body = tok[1:-1]
        if q == "'":
            if "'" in body.replace("''", ""):
                raise YamlSubsetError(f"{where}: stray quote in {tok!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise YamlSubsetError(f"{where}: escapes in double-quoted strings are not supported: {tok!r}")
        return body
    if tok in _SPECIAL:
        return _SPECIAL[tok]
    if re.match(r"[-+]?0[0-9]", tok):   # YAML 1.1 octal: read differently by yaml-cpp and pyyaml
        raise YamlSubsetError(f"{where}: number with a leading zero {tok!r}")
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if tok[0] in "[]{},&*!|>%@`" or tok.startswith("- ") or ": " in tok or tok.endswith(":"):
        raise YamlSubsetError(f"{where}: unsupported value {tok!r}")
    return tok


def _split_flow(body, where):
    """Split the inside of a flow collection at top-level commas."""
    parts, cur, quote = [], "", None
    for c in body:
        if quote:
            quote = None if c == quote else quote
        elif c in "\"'":
            quote = c
        elif c in "[]{}":
            raise YamlSubsetError(f"{where}: nested flow collections are not supported")
        elif c == ",":
            parts.append(cur.strip())
            cur = ""
            continue
        cur += c
    parts.append(cur.strip())
    if parts == [""]:
        return []
    if "" in parts:
        raise YamlSubsetError(f"{where}: empty entry in a flow collection")
    return parts


def _value(text, where):
    """A flow list, a flow map or a scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: unterminated flow list {text!r}")
        return [_scalar(p, where) for p in _split_flow(text[1:-1], where)]
    if text.startswith("{"):
        if not text.endswith("}"):
            raise YamlSubsetError(f"{where}: unterminated flow map {text!r}")
        out = {}
        for p in _split_flow(text[1:-1], where):
            m = _KEY.match(p + " ")
            if not m:
                raise YamlSubsetError(f"{where}: flow map entry {p!r} is not 'key: value'")
            out[m.group(1)] = _scalar(p[m.end():].strip(), where)
        return out
    return _scalar(text, where)


def parse_yaml(text, name="gvins.yaml"):
    """The mapping a gvins.yaml text holds, read without pyyaml. Reads
    top-level ``key: value`` lines whose values are scalars (ints, floats,
    booleans, nulls, plain or quoted strings), flow lists and flow maps, and
    one level of indented block maps under a key with no value (``cam0:``);
    a flow collection may span lines until its bracket closes. Comments,
    blank lines, a leading ``---`` and CRLF line ends are accepted. Anything
    else raises ``YamlSubsetError`` with the line number."""
    lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
    out = {}
    open_key, block_indent = None, None   # a top-level key with no value, its block's indent
    i = 0
    while i < len(lines):
        lineno = i + 1
        where = f"{name}:{lineno}"
        body = _strip_comment(lines[i])
        i += 1
        if not body.strip() or (lineno == 1 and body.strip() == "---"):
            continue
        indent = len(body) - len(body.lstrip())
        if "\t" in body[:indent]:
            raise YamlSubsetError(f"{where}: tab in indentation")
        body = body.strip()
        while body.count("[") > body.count("]") or body.count("{") > body.count("}"):
            if i >= len(lines):
                raise YamlSubsetError(f"{where}: unterminated flow collection")
            body += " " + _strip_comment(lines[i]).strip()
            i += 1
        m = _KEY.match(body)
        if not m:
            raise YamlSubsetError(f"{where}: expected 'key: value', got {body!r}")
        key, rest = m.group(1), body[m.end():].strip()
        if indent == 0:
            target, open_key = out, None
        elif open_key is not None and block_indent in (None, indent):
            block_indent = indent
            if out[open_key] is None:
                out[open_key] = {}
            target = out[open_key]
        else:
            raise YamlSubsetError(f"{where}: unexpected indentation (one level of block maps)")
        if key in target:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        if rest == "":
            if indent:
                raise YamlSubsetError(f"{where}: nested block maps are not supported")
            out[key], open_key, block_indent = None, key, None
            continue
        target[key] = _value(rest, where)
    return out
