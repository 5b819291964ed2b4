"""Configuration of the port: the full default tree, YAML files with
``_BASE_`` inheritance, and dotted ``KEY VALUE`` overrides.

Port of ``mgnet_tpu/config.py``. ``ConfigNode`` is a dict with attribute
access, freezing, ``clone``, ``merge_dict``, ``merge_from_file``,
``merge_from_list`` and ``to_dict``, as the JAX package's. A key the tree
does not hold raises ``KeyError``, in a file as in the overrides.

``get_default_config()`` holds every key of the JAX package's tree except
its four TPU-only switches (``TPU_ONLY_KEYS``): the port always runs its
kernels on the card, and its warp is the exact f32 gather. Those four
raise as unknown, with a message that names them.

A key carried so that the shipped YAML files load, which no code of the
port reads: ``TEST.AMP.ENABLED``, which no code of the JAX package reads
either (the eval step's dtype is ``MODEL.COMPUTE_DTYPE``). The trainer
(``train/trainer.py``) reads ``DATASETS.*``, ``DATALOADER.*``,
``INPUT.*``, ``MODEL.WEIGHTS``, ``OUTPUT_DIR``, ``TEST.*`` and ``MESH.*``
(``parallel.data_parallel_size``: ``DATA`` x ``MODEL`` ranks, ``DATA``
-1 for the ranks over ``MODEL``; the ``MODEL`` ranks of one data shard
hold copies of it, as the JAX package's model axis).

The card's machine has no PyYAML, so the files are read by ``parse_yaml``,
a reader of the subset the shipped configs use: nested block maps by
indentation; plain, single- and double-quoted scalars; flow lists of
scalars; full-line and trailing ``#`` comments. Plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1): ``0.0001`` is a float,
``1e-4`` (no dot) a string. Anything else (block sequences, flow maps,
anchors, tags, block or multi-line scalars, tabs, and the YAML 1.1
scalars the configs never use: yes/no/on/off, binary, octal, hex and
base-60 numbers) raises ``YamlError`` with the file and line. ``dump_yaml`` writes the same subset back.
"""

from __future__ import annotations

import ast
import copy
import math
import os
import re
from pathlib import Path
from typing import Any, Dict, List

__all__ = ["ConfigNode", "TPU_ONLY_KEYS", "YamlError", "apply_cityscapes_fine",
           "dump_yaml", "get_default_config", "load_config", "parse_yaml"]

# the shipped configs/*.yaml, beside the package
CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"

_FROZEN = "__frozen__"
_BASE_KEY = "_BASE_"

# switches of the JAX package that select its Pallas TPU kernels
TPU_ONLY_KEYS = (
    "MODEL.DEPTH_HEAD.USE_PALLAS_SSIM",
    "MODEL.DEPTH_HEAD.USE_PALLAS_WARP",
    "MODEL.DEPTH_HEAD.PALLAS_WARP_FAST",
    "MODEL.POST_PROCESSING.USE_PALLAS_FUSION",
)


def _unknown(path: str) -> KeyError:
    if path in TPU_ONLY_KEYS:
        return KeyError(f"Unknown config key: {path} (a TPU-only switch of "
                        f"the JAX package; the port always runs its CUDA "
                        f"kernels on the card)")
    return KeyError(f"Unknown config key: {path}")


class ConfigNode(dict):
    """A dict with attribute access, freezing and merging."""

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"Config has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{name}' on a frozen config")
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        self[name] = value

    def __delattr__(self, name: str) -> None:
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError("Cannot delete from a frozen config")
        del self[name]

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def clone(self) -> "ConfigNode":
        out = ConfigNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def merge_dict(self, other: Dict[str, Any], allow_new: bool = False,
                   _path: str = "") -> None:
        """Recursively merge ``other`` into self; unknown keys raise
        ``KeyError`` unless ``allow_new``."""
        if self.is_frozen():
            raise AttributeError("Cannot merge into a frozen config")
        for k, v in other.items():
            path = _path + k
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_dict(v, allow_new, _path=path + ".")
            else:
                if k not in self and not allow_new:
                    raise _unknown(path)
                self[k] = (ConfigNode(v) if isinstance(v, dict)
                           else _coerce(v, self.get(k)))

    def merge_from_file(self, path: str, allow_new: bool = False) -> None:
        self.merge_dict(_load_yaml_with_base(path), allow_new=allow_new)

    def merge_from_list(self, opts: List[str]) -> None:
        """Merge dotted KEY VALUE pairs, e.g. ["SOLVER.BASE_LR", "0.01"];
        values go through ``ast.literal_eval`` where they parse."""
        if len(opts) % 2:
            raise ValueError(f"opts must be KEY VALUE pairs, got {opts}")
        if self.is_frozen():
            raise AttributeError("Cannot merge into a frozen config")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.get(p)
                if not isinstance(node, ConfigNode):
                    raise _unknown(key)
            leaf = parts[-1]
            if leaf not in node:
                raise _unknown(key)
            node[leaf] = _coerce(_parse_literal(value), node[leaf])

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, ConfigNode) else v)
                for k, v in self.items()}

    def dump(self) -> str:
        return dump_yaml(self.to_dict())


def _parse_literal(s: Any) -> Any:
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _coerce(value: Any, old: Any) -> Any:
    """Light type coercion so that override scalars keep the default's
    type: bool from int, float from int, tuple and list kept."""
    if old is None or value is None:
        return value
    if isinstance(old, bool) and isinstance(value, int):
        return bool(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    return value


# ---------------------------------------------------------------------------
# The YAML subset
# ---------------------------------------------------------------------------


class YamlError(ValueError):
    """A line outside the YAML subset the port reads."""


_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
_NULL = ("", "~", "null", "Null", "NULL")
# the decimal forms of PyYAML's implicit int and float resolvers (YAML 1.1)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
# what YAML 1.1 would resolve to a bool or a number in a form the shipped
# configs never use: yes/no/on/off, binary, octal, hex and base 60
_REFUSED = re.compile(r"""^(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF
    |[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$""", re.X)
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.]*)\s*:(?:\s+|$)(.*)$")


def _plain(text: str, where: str) -> Any:
    """Resolve a plain scalar as PyYAML's SafeLoader does; the YAML 1.1
    forms of ``_REFUSED`` raise."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _REFUSED.match(text):
        raise YamlError(f"{where}: '{text}' is outside the YAML subset the "
                        f"port reads (yes/no/on/off, binary, octal, hex and "
                        f"base-60 numbers); quote it or write it in decimal")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return -math.inf if v[0] == "-" else math.inf
        if v == ".nan":
            return math.nan
        return float(v)
    return text


def _quoted(text: str, where: str) -> tuple:
    """Read the quoted scalar at the start of ``text``: (value, rest)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            table = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t",
                     "r": "\r", "0": "\0"}
            if esc not in table:
                raise YamlError(f"{where}: unsupported escape '\\{esc}'")
            out.append(table[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    raise YamlError(f"{where}: unterminated quoted scalar (multi-line "
                    f"scalars are not read)")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment (``#`` after whitespace)."""
    text = text.strip()
    if text.startswith("#"):
        return ""
    m = re.search(r"\s#", text)
    return text[:m.start()].rstrip() if m else text


def _scalar(text: str, where: str) -> Any:
    """A value: a quoted or plain scalar, its comment stripped."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, where)
        if _strip_comment(rest):
            raise YamlError(f"{where}: text after a quoted scalar")
        return value
    text = _strip_comment(text)
    if text[:1] in ("&", "*", "!", "|", ">", "{", "[", "%", "@", "`", "?") \
            or text == "-" or text.startswith("- "):
        raise YamlError(f"{where}: '{text}' is outside the YAML subset the "
                        f"port reads (anchors, aliases, tags, block scalars, "
                        f"flow maps, sequences)")
    if ": " in text or text.endswith(":"):
        raise YamlError(f"{where}: nested mapping on one line")
    return _plain(text, where)


def _flow_list(text: str, where: str) -> List[Any]:
    """A flow list of scalars, ``[a, "b", 3]``, and nothing after it but a
    comment."""
    items: List[Any] = []
    rest = text[1:].lstrip()
    if rest.startswith("]"):
        if _strip_comment(rest[1:]):
            raise YamlError(f"{where}: text after a flow list")
        return items
    while True:
        if not _strip_comment(rest):
            raise YamlError(f"{where}: flow list not closed on its line")
        if rest[:1] in ("'", '"'):
            value, rest = _quoted(rest, where)
            rest = rest.lstrip()
        else:
            m = re.match(r"([^,\]\[{}#]*)", rest)
            token = m.group(1).strip()
            rest = rest[m.end():]
            if not token:
                raise YamlError(f"{where}: empty or nested flow list item")
            value = _scalar(token, where)
        items.append(value)
        if rest.startswith(","):
            rest = rest[1:].lstrip()
            continue
        if rest.startswith("]"):
            if _strip_comment(rest[1:]):
                raise YamlError(f"{where}: text after a flow list")
            return items
        raise YamlError(f"{where}: flow list not closed on its line")


def parse_yaml(text: str, name: str = "<string>") -> Dict[str, Any]:
    """Read the YAML subset described in the module docstring into nested
    dicts. An empty document gives {}."""
    root: Dict[str, Any] = {}
    # (indent of the node's keys or None until its first key, node)
    stack: List[list] = [[0, root]]
    pending = None  # (key, parent, indent) of a 'KEY:' with no value yet
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        if "\t" in raw:
            raise YamlError(f"{where}: tab character (YAML indents with "
                            f"spaces)")
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        indent = len(body) - len(stripped)
        if stripped.startswith(("- ", "-")) and (stripped == "-"
                                                 or stripped[1] == " "):
            raise YamlError(f"{where}: block sequences are not read; write "
                            f"a flow list [a, b]")
        if stripped.startswith(("---", "...", "%")):
            raise YamlError(f"{where}: document markers and directives are "
                            f"not read")
        if pending is not None:
            key, parent, parent_indent = pending
            pending = None
            if indent > parent_indent:
                child: Dict[str, Any] = {}
                parent[key] = child
                stack.append([indent, child])
            else:
                parent[key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise YamlError(f"{where}: indentation does not match any "
                            f"enclosing mapping (multi-line scalars are not "
                            f"read)")
        node = stack[-1][1]
        m = _KEY.match(stripped)
        if not m:
            raise YamlError(f"{where}: expected 'KEY: value' in the YAML "
                            f"subset the port reads, got '{stripped}'")
        key, value = m.group(1), m.group(2)
        if _plain(key, where) != key:
            raise YamlError(f"{where}: the key '{key}' would not read as a "
                            f"string")
        if key in node:
            raise YamlError(f"{where}: duplicate key '{key}'")
        value = value.strip()
        if not _strip_comment(value) and value[:1] not in ("'", '"'):
            node[key] = None
            pending = (key, node, indent)
        elif value.startswith("["):
            node[key] = _flow_list(value, where)
        else:
            node[key] = _scalar(value, where)
    return root


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text:
            mant, exp = text.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            text = f"{mant}e{exp}"
        elif "." not in text:
            text += ".0"
        return text
    if isinstance(v, str):
        if "\n" in v or "\r" in v or "\t" in v or "\0" in v:
            raise YamlError(f"cannot dump {v!r}: control characters")
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise YamlError(f"cannot dump a {type(v).__name__}: {v!r}")


def dump_yaml(data: Dict[str, Any], indent: int = 0) -> str:
    """Write nested dicts of scalars and flat lists or tuples in the subset
    ``parse_yaml`` reads (tuples come back as lists)."""
    lines = []
    pad = " " * indent
    for k, v in data.items():
        if not isinstance(k, str) or not _KEY.match(f"{k}: x"):
            raise YamlError(f"cannot dump the key {k!r}")
        if isinstance(v, dict):
            if not v:
                raise YamlError(f"cannot dump the empty mapping {k}")
            lines.append(f"{pad}{k}:")
            lines.append(dump_yaml(v, indent + 2).rstrip("\n"))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{k}: [" + ", ".join(
                _dump_scalar(x) for x in v) + "]")
        else:
            lines.append(f"{pad}{k}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"


def _load_yaml_with_base(path: str) -> Dict[str, Any]:
    """Read a YAML file, resolving ``_BASE_`` (relative to the file's own
    directory) recursively."""
    with open(path) as f:
        data = parse_yaml(f.read(), name=str(path))
    base_rel = data.pop(_BASE_KEY, None)
    if base_rel is None:
        return data
    base_path = base_rel
    if not os.path.isabs(base_path):
        base_path = os.path.join(os.path.dirname(path), base_path)
    base = _load_yaml_with_base(base_path)
    _deep_update(base, data)
    return base


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


# ---------------------------------------------------------------------------
# The default tree: mgnet_tpu/config.py:174-399 without TPU_ONLY_KEYS
# ---------------------------------------------------------------------------


def _decoder_head(num_classes=None) -> ConfigNode:
    h = ConfigNode()
    h.IN_FEATURES = ["res3", "res4", "res5"]
    h.COMMON_STRIDE = 8
    h.ARM_CHANNELS = [128, 128]
    h.REFINE_CHANNELS = [128, 128]
    h.FFM_CHANNELS = 256
    h.HEAD_CHANNELS = 256
    h.INIT_METHOD = "xavier"
    if num_classes is not None:
        h.NUM_CLASSES = num_classes
    return h


def get_default_config() -> ConfigNode:
    c = ConfigNode()

    c.VERSION = 2
    c.OUTPUT_DIR = "./output"
    c.WRITE_OUTPUT_TO_SUBDIR = True
    c.COMMIT_ID = ""
    c.SEED = 0

    c.WITH_PANOPTIC = True
    c.WITH_DEPTH = True
    c.WITH_UNCERTAINTY = True
    c.VISUALIZE_EVALUATION = False

    c.MODEL = ConfigNode()
    c.MODEL.META_ARCHITECTURE = "MGNet"
    c.MODEL.WEIGHTS = ""
    c.MODEL.PIXEL_MEAN = [123.675, 116.280, 103.530]
    c.MODEL.PIXEL_STD = [58.395, 57.120, 57.375]
    c.MODEL.SIZE_DIVISIBILITY = 32
    # conv stack dtype: "bfloat16" (autocast) or "float32"
    c.MODEL.COMPUTE_DTYPE = "bfloat16"
    # torch.utils.checkpoint around each residual block, each head and
    # the photometric loss: recompute in the backward for activation memory
    c.MODEL.REMAT = False

    c.MODEL.BACKBONE = ConfigNode()
    c.MODEL.BACKBONE.NAME = "resnet_abn"
    # the solver's update mask: 1 freezes the stem, k also res2..res{k}
    c.MODEL.BACKBONE.FREEZE_AT = 0

    c.MODEL.RESNETS = ConfigNode()
    c.MODEL.RESNETS.DEPTH = 18
    c.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    c.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    c.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]

    c.MODEL.GCM = ConfigNode()
    c.MODEL.GCM.GCM_CHANNELS = 128
    c.MODEL.GCM.INIT_METHOD = "xavier"

    c.MODEL.SEM_SEG_HEAD = _decoder_head(num_classes=20)
    c.MODEL.SEM_SEG_HEAD.NAME = "MGNetSemSegHead"
    c.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
    c.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0
    c.MODEL.SEM_SEG_HEAD.LOSS_TYPE = "ohem"
    c.MODEL.SEM_SEG_HEAD.LOSS_TOP_K = 0.2
    c.MODEL.SEM_SEG_HEAD.OHEM_THRESHOLD = 0.7
    c.MODEL.SEM_SEG_HEAD.OHEM_N_MIN = 100000

    c.MODEL.INS_EMBED_HEAD = _decoder_head()
    c.MODEL.INS_EMBED_HEAD.NAME = "MGNetInsEmbedHead"
    c.MODEL.INS_EMBED_HEAD.CENTER_LOSS_WEIGHT = 200.0
    c.MODEL.INS_EMBED_HEAD.OFFSET_LOSS_WEIGHT = 0.01

    c.MODEL.DEPTH_HEAD = _decoder_head()
    c.MODEL.DEPTH_HEAD.NAME = "MGNetSelfSupervisedDepthHead"
    c.MODEL.DEPTH_HEAD.INIT_METHOD = "default"
    c.MODEL.DEPTH_HEAD.MSC_LOSS = True
    c.MODEL.DEPTH_HEAD.SSIM_LOSS_WEIGHT = 0.85
    c.MODEL.DEPTH_HEAD.PHOTOMETRIC_LOSS_WEIGHT = 1.0
    c.MODEL.DEPTH_HEAD.SMOOTHING_LOSS_WEIGHT = 0.001
    c.MODEL.DEPTH_HEAD.AUTOMASK_LOSS = True
    c.MODEL.DEPTH_HEAD.PHOTOMETRIC_REDUCE_OP = "min"
    c.MODEL.DEPTH_HEAD.PADDING_MODE = "zeros"

    c.MODEL.POST_PROCESSING = ConfigNode()
    c.MODEL.POST_PROCESSING.STUFF_AREA = 2048
    c.MODEL.POST_PROCESSING.CENTER_THRESHOLD = 0.3
    c.MODEL.POST_PROCESSING.NMS_KERNEL = 7
    c.MODEL.POST_PROCESSING.USE_DGC_SCALING = True
    c.MODEL.POST_PROCESSING.MAX_INSTANCES = 128

    c.SOLVER = ConfigNode()
    c.SOLVER.OPTIMIZER = "ADAM"
    c.SOLVER.BASE_LR = 0.0001
    c.SOLVER.MAX_ITER = 60000
    c.SOLVER.IMS_PER_BATCH = 12
    # split each batch into k micro-batches, forward and backward each,
    # average the gradients, step once (train/step.py)
    c.SOLVER.GRAD_ACCUM_STEPS = 1
    c.SOLVER.LR_SCHEDULER_NAME = "WarmupPolyLR"
    c.SOLVER.POLY_LR_POWER = 0.9
    c.SOLVER.POLY_LR_CONSTANT_ENDING = 0.0
    c.SOLVER.WARMUP_FACTOR = 0.1
    c.SOLVER.WARMUP_ITERS = 1000
    c.SOLVER.HEAD_LR_FACTOR = 10.0
    c.SOLVER.WEIGHT_DECAY = 0.0
    c.SOLVER.WEIGHT_DECAY_NORM = 0.0
    c.SOLVER.WEIGHT_DECAY_BIAS = 0.0
    c.SOLVER.MOMENTUM = 0.9
    c.SOLVER.CHECKPOINT_PERIOD = 5000
    c.SOLVER.CLIP_GRADIENTS = ConfigNode()
    c.SOLVER.CLIP_GRADIENTS.ENABLED = True
    c.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    c.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    c.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    c.SOLVER.AMP = ConfigNode()
    c.SOLVER.AMP.ENABLED = True

    c.INPUT = ConfigNode()
    c.INPUT.FORMAT = "RGB"
    c.INPUT.MIN_SIZE_TRAIN = (512, 640, 704, 832, 896, 1024, 1152, 1216, 1344,
                              1408, 1536, 1664, 1728, 1856, 1920, 2048)
    c.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    c.INPUT.MIN_SIZE_TEST = 1024
    c.INPUT.MAX_SIZE_TRAIN = 4096
    c.INPUT.MAX_SIZE_TEST = 2048
    c.INPUT.RANDOM_FLIP = "horizontal"
    c.INPUT.CROP = ConfigNode()
    c.INPUT.CROP.ENABLED = True
    c.INPUT.CROP.TYPE = "absolute"
    c.INPUT.CROP.SIZE = (1024, 1024)
    c.INPUT.CROP.RANDOM_PAD_TO_CROP_SIZE = True
    c.INPUT.COLOR_JITTER = ConfigNode()
    c.INPUT.COLOR_JITTER.ENABLED = True
    c.INPUT.COLOR_JITTER.BRIGHTNESS = 0.2
    c.INPUT.COLOR_JITTER.CONTRAST = 0.2
    c.INPUT.COLOR_JITTER.SATURATION = 0.2
    c.INPUT.COLOR_JITTER.HUE = 0.05
    c.INPUT.GAUSSIAN_SIGMA = 8
    c.INPUT.IGNORE_STUFF_IN_OFFSET = True
    c.INPUT.SMALL_INSTANCE_AREA = 4096
    c.INPUT.SMALL_INSTANCE_WEIGHT = 3
    c.INPUT.IGNORE_CROWD_IN_SEMANTIC = False
    c.INPUT.IGNORED_CATEGORIES_IN_DEPTH = []
    c.INPUT.TRAIN_DATASET_MAPPER = "mgnet_tpu_torch.data.TrainDatasetMapper"
    c.INPUT.TEST_DATASET_MAPPER = "mgnet_tpu_torch.data.TestDatasetMapper"

    c.DATASETS = ConfigNode()
    c.DATASETS.TRAIN = ("cityscapes_fine_scene_seg_train",)
    c.DATASETS.TEST = ("cityscapes_fine_scene_seg_val",)

    c.DATALOADER = ConfigNode()
    c.DATALOADER.NUM_WORKERS = 10
    c.DATALOADER.PREFETCH = 4
    c.DATALOADER.DECODE_CACHE_DIR = ""

    c.TEST = ConfigNode()
    c.TEST.EVAL_PERIOD = 5000
    c.TEST.AMP = ConfigNode()
    c.TEST.AMP.ENABLED = True
    c.TEST.MSC_FLIP_EVAL = False
    c.TEST.EVAL_SEMANTIC = True
    c.TEST.EVAL_INSTANCE = False
    c.TEST.MIN_DEPTH = 0.001
    c.TEST.MAX_DEPTH = 80.0
    c.TEST.IMS_PER_BATCH = 4
    c.TEST.TTA_IMS_PER_BATCH = 4

    c.MESH = ConfigNode()
    c.MESH.DATA = -1
    c.MESH.MODEL = 1

    return c


def load_config(path: str | None = None,
                opts: List[str] | None = None) -> ConfigNode:
    """The default tree, then the YAML file at ``path`` (with its
    ``_BASE_`` chain), then the dotted ``opts`` overrides."""
    cfg = get_default_config()
    if path:
        cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg


def apply_cityscapes_fine(cfg: ConfigNode) -> ConfigNode:
    """Merge configs/MGNet-Cityscapes-Fine.yaml, the flagship joint
    panoptic + depth recipe, into ``cfg`` in place; returns ``cfg``."""
    cfg.merge_from_file(str(CONFIG_DIR / "MGNet-Cityscapes-Fine.yaml"))
    return cfg
