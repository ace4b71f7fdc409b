"""Config tree: the ``ConfigNode`` of ``bbdm_tpu/config.py``, a reader and a
writer for the YAML subset of ``configs/*.yaml`` that need no PyYAML, the CLI
overrides of ``main_torch.py``, and a Python-dict twin of
``configs/Template-LBBDM-f4.yaml``.

:func:`load_config` resolves every scalar as ``yaml.FullLoader`` does (YAML
1.1: ``1.e-4`` is a float, ``1e-4`` a string) and reads block maps, block
lists (with ``!!python/tuple`` before one), empty values, quoted strings,
flow lists of scalars and trailing comments. Anything else raises
:class:`ConfigSyntaxError` with the file and line.
"""

from __future__ import annotations

import copy
import json
import math
import re
from types import SimpleNamespace
from typing import Any


class ConfigNode(SimpleNamespace):
    """Nested attribute namespace with ``in``, ``get`` and ``to_dict``
    (same behaviour as ``bbdm_tpu.config.ConfigNode``)."""

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def keys(self):
        return vars(self).keys()

    def items(self):
        return vars(self).items()

    def to_dict(self) -> dict:
        return namespace2dict(self)

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)


def dict2namespace(d: dict) -> ConfigNode:
    """Recursively convert a dict into a ConfigNode tree."""
    node = ConfigNode()
    for key, value in d.items():
        if isinstance(value, dict):
            value = dict2namespace(value)
        setattr(node, key, value)
    return node


def namespace2dict(ns) -> dict:
    """Inverse of dict2namespace."""
    out = {}
    for key, value in vars(ns).items():
        out[key] = namespace2dict(value) if isinstance(value, SimpleNamespace) else value
    return out


# ---------------------------------------------------------------- YAML reader

class ConfigSyntaxError(ValueError):
    """A construct outside the YAML subset this reader takes."""


# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))")
# resolved by PyYAML to other types (sexagesimal numbers, timestamps, merge and
# value keys): this reader refuses them
_OTHER = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*")


def _resolve_plain(text: str):
    """A plain (unquoted) scalar as yaml.FullLoader constructs it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.fullmatch(text):
        s = text.replace("_", "").lower()
        if s.endswith(".inf"):
            return -math.inf if s[0] == "-" else math.inf
        if s == ".nan":
            return math.nan
        return float(s)
    if _INT.fullmatch(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _OTHER.fullmatch(text):
        raise ConfigSyntaxError(f"unsupported scalar {text!r}")
    if text[0] in "[]{}&*!|>'\"%@`," or text.startswith(("- ", "? ", ": ")):
        raise ConfigSyntaxError(f"unsupported plain scalar {text!r}")
    return text


def _quoted(text: str):
    """(string, rest) for a scalar that opens with a quote."""
    q = text[0]
    i, out = 1, []
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            table = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}
            if esc not in table:
                raise ConfigSyntaxError(f"unsupported escape \\{esc}")
            out.append(table[esc])
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        out.append(ch)
        i += 1
    raise ConfigSyntaxError("unterminated quoted string")


def _only_comment(rest: str) -> None:
    """Text after a closed quote or flow list may only be a comment."""
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ConfigSyntaxError(f"unexpected text after a closed value: {rest!r}")


def _scalar(text: str):
    """A single-line value: quoted string, flow list of scalars, or plain scalar
    (a `` #`` starts a comment)."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text)
        _only_comment(rest)
        return value
    if text.startswith("["):
        end = text.find("]")
        if end < 0:
            raise ConfigSyntaxError("unterminated flow list")
        _only_comment(text[end + 1:])
        inner = text[1:end].strip()
        if not inner:
            return []
        if any(c in inner for c in "[]{}#"):
            raise ConfigSyntaxError(f"unsupported flow list {text!r}")
        return [_scalar(item) for item in inner.split(",")]
    if text.startswith("{"):
        if re.match(r"\{\s*\}\s*(#.*)?$", text):
            return {}
        raise ConfigSyntaxError(f"unsupported flow mapping {text!r}")
    m = re.search(r"\s#", text)
    if m:
        text = text[:m.start()].rstrip()
    if text.startswith("#"):
        text = ""
    return _resolve_plain(text)


def _lines(source: str):
    """(line number, indent, content) of every line that is not blank or a comment."""
    out = []
    for no, raw in enumerate(source.splitlines(), 1):
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body[:len(body) - len(stripped) + 1]:
            raise ConfigSyntaxError(f"line {no}: tab in indentation")
        if stripped in ("---", "...") or stripped.startswith(("%", "&", "*", "? ")):
            raise ConfigSyntaxError(f"line {no}: unsupported construct {stripped!r}")
        out.append((no, len(body) - len(stripped), stripped))
    return out


class _Parser:
    def __init__(self, lines):
        self.lines, self.i = lines, 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent):
        line = self.peek()
        if line[2] == "-" or line[2].startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent):
        out = []
        while (line := self.peek()) is not None and line[1] == indent and \
                (line[2] == "-" or line[2].startswith("- ")):
            no, _, text = line
            self.i += 1
            item = text[1:].strip()
            if not item or re.match(r"[A-Za-z_][\w.-]*:(\s|$)", item) or item.startswith("- "):
                raise ConfigSyntaxError(f"line {no}: only scalars are taken as list items")
            out.append(self.value(item, no))
        self.expect_end(indent)
        return out

    def mapping(self, indent):
        out = {}
        while (line := self.peek()) is not None and line[1] == indent:
            no, _, text = line
            m = re.match(r"([^\s:#'\"\[\]{}][^:#]*?)\s*:(?:\s+(.*))?$", text)
            if not m or not _KEY.fullmatch(m.group(1)) or \
                    not isinstance(_resolve_plain(m.group(1)), str):
                raise ConfigSyntaxError(f"line {no}: expected 'key: value' with a string "
                                        f"key, got {text!r}")
            self.i += 1
            key, rest = m.group(1), (m.group(2) or "").strip()
            tag = None
            if rest.startswith("!!"):
                tag, _, rest = rest.partition(" ")
                rest = rest.strip()
                if tag != "!!python/tuple" or (rest and not rest.startswith("#")):
                    raise ConfigSyntaxError(f"line {no}: unsupported tag use {text!r}")
            if rest and not rest.startswith("#"):
                out[key] = self.value(rest, no)
                continue
            nxt = self.peek()
            if nxt is not None and (nxt[1] > indent or (
                    nxt[1] == indent and (nxt[2] == "-" or nxt[2].startswith("- ")))):
                child = self.block(nxt[1])
            else:
                child = None
            if tag is not None:
                if not isinstance(child, list):
                    raise ConfigSyntaxError(f"line {no}: !!python/tuple needs a block list")
                child = tuple(child)
            out[key] = child
        self.expect_end(indent)
        return out

    def value(self, text, no):
        try:
            return _scalar(text)
        except ConfigSyntaxError as e:
            raise ConfigSyntaxError(f"line {no}: {e}") from None

    def expect_end(self, indent):
        line = self.peek()
        if line is not None and line[1] > indent:
            raise ConfigSyntaxError(f"line {line[0]}: unexpected indentation")


def parse_yaml(source: str):
    """The YAML subset of ``configs/*.yaml`` -> plain Python tree."""
    lines = _lines(source)
    if not lines:
        return None
    parser = _Parser(lines)
    if lines[0][1] != 0:
        raise ConfigSyntaxError(f"line {lines[0][0]}: the document must start at column 0")
    tree = parser.block(0)
    if parser.peek() is not None:
        raise ConfigSyntaxError(f"line {parser.peek()[0]}: unexpected text")
    return tree


def load_config(path: str) -> ConfigNode:
    """Read a YAML config with the same result as ``yaml.load(f, yaml.FullLoader)``
    for the constructs of ``configs/*.yaml``; raises ConfigSyntaxError (file
    and line) on any other."""
    with open(path, "r") as f:
        source = f.read()
    try:
        tree = parse_yaml(source)
    except ConfigSyntaxError as e:
        raise ConfigSyntaxError(f"{path}: {e}") from None
    if not isinstance(tree, dict):
        raise ConfigSyntaxError(f"{path}: the top level must be a mapping")
    return dict2namespace(tree)


# ---------------------------------------------------------------- YAML writer

def _plain(obj):
    """Values PyYAML's safe types can hold (tuples -> lists, others -> str), as
    ``bbdm_tpu/config.py:_plain``."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _emit_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):  # PyYAML's represent_float
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if any(c in v for c in "\n\r\t\\") or not v.isprintable():
        return json.dumps(v)
    return "'" + v.replace("'", "''") + "'"


def _emit(tree, indent: int, out: list) -> None:
    pad = " " * indent
    for key in sorted(tree):
        value = tree[key]
        if not isinstance(key, str) or not _KEY.fullmatch(key) or \
                not isinstance(_resolve_plain(key), str):
            raise ValueError(f"config key {key!r} cannot be written")
        if isinstance(value, dict) and value:
            out.append(f"{pad}{key}:")
            _emit(value, indent + 2, out)
        elif isinstance(value, dict):
            out.append(f"{pad}{key}: {{}}")
        elif isinstance(value, list) and value:
            out.append(f"{pad}{key}:")
            for item in value:
                if isinstance(item, (dict, list)):
                    raise ValueError(f"config key {key!r}: nested containers in a list")
                out.append(f"{pad}- {_emit_scalar(item)}")
        elif isinstance(value, list):
            out.append(f"{pad}{key}: []")
        else:
            out.append(f"{pad}{key}: {_emit_scalar(value)}")


def save_config(config: ConfigNode, path: str) -> None:
    """Snapshot a config tree as YAML (tuples as lists) that PyYAML and
    :func:`load_config` read back to the same tree."""
    out: list = []
    _emit(_plain(namespace2dict(config)), 0, out)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


# ---------------------------------------------------------------- CLI

def device_from_gpu_ids(gpu_ids: str) -> str:
    """``--gpu_ids``: "-1" is the CPU, one id N is ``cuda:N``. Several ids
    raise: data-parallel sampling is not ported (ROADMAP.md §1 item 5)."""
    ids = [s.strip() for s in str(gpu_ids).split(",") if s.strip()]
    if len(ids) != 1:
        raise NotImplementedError(
            f"--gpu_ids {gpu_ids!r}: give -1 (CPU) or one card id; data-parallel "
            "sampling over several cards is not ported (ROADMAP.md §1 item 5)")
    if ids[0] == "-1":
        return "cpu"
    if not ids[0].isdigit():
        raise ValueError(f"--gpu_ids {gpu_ids!r}: not a card id")
    return f"cuda:{int(ids[0])}"


def apply_cli_overrides(config: ConfigNode, args) -> ConfigNode:
    """Fold CLI args into the config tree (``bbdm_tpu/config.py:125-146``):
    resume paths and epoch/step caps override the YAML values; the args
    namespace is kept at ``config.args``. ``--gpu_ids`` is checked here
    (:func:`device_from_gpu_ids`) and read by the runner."""
    device_from_gpu_ids(getattr(args, "gpu_ids", "0"))
    config.args = args
    if getattr(args, "resume_model", None) is not None:
        config.model.model_load_path = args.resume_model
    if getattr(args, "resume_optim", None) is not None:
        config.model.optim_sche_load_path = args.resume_optim
    if getattr(args, "max_epoch", None) is not None:
        config.training.n_epochs = args.max_epoch
    if getattr(args, "max_steps", None) is not None:
        config.training.n_steps = args.max_steps
    return config


# configs/Template-LBBDM-f4.yaml as loaded by bbdm_tpu.config.load_config
# (tests/test_torch_package.py holds the two equal).
_LBBDM_F4 = {
    "runner": "BBDMRunner",
    "training": {
        "n_epochs": 100, "n_steps": 200000, "save_interval": 2,
        "sample_interval": 2, "validation_interval": 2,
        "accumulate_grad_batches": 4,
    },
    "testing": {"clip_denoised": False, "sample_num": 5},
    "data": {
        "dataset_name": "dataset_name",
        "dataset_type": "custom_aligned",
        "dataset_config": {
            "dataset_path": "dataset_path", "image_size": 256, "channels": 3,
            "to_normal": True, "flip": False,
        },
        "train": {"batch_size": 8, "shuffle": True},
        "val": {"batch_size": 8, "shuffle": True},
        "test": {"batch_size": 8},
    },
    "model": {
        "model_name": "LBBDM-f4",
        "model_type": "LBBDM",
        "latent_before_quant_conv": False,
        "normalize_latent": False,
        "only_load_latent_mean_std": False,
        "mixed_precision": True,
        "init_scheme": "reference",
        "EMA": {"use_ema": True, "ema_decay": 0.995, "update_ema_interval": 8,
                "start_ema_step": 30000},
        "CondStageParams": {"n_stages": 2, "in_channels": 3, "out_channels": 3},
        "VQGAN": {"params": {
            "ckpt_path": "results/VQGAN/CelebAMaskHQ-f4.ckpt",
            "embed_dim": 3,
            "n_embed": 8192,
            "ddconfig": {
                "double_z": False, "z_channels": 3, "resolution": 256,
                "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": (1, 2, 4),
                "num_res_blocks": 2, "attn_resolutions": [], "dropout": 0.0,
            },
            "lossconfig": {"target": "torch.nn.Identity"},
        }},
        "BB": {
            "optimizer": {"weight_decay": 0.0, "optimizer": "Adam", "lr": 1.0e-4,
                          "beta1": 0.9},
            "lr_scheduler": {"factor": 0.5, "patience": 3000, "threshold": 0.0001,
                             "cooldown": 3000, "min_lr": 5.0e-7},
            "params": {
                "mt_type": "linear", "objective": "grad", "loss_type": "l1",
                "skip_sample": True, "sample_type": "linear", "sample_step": 200,
                "num_timesteps": 1000, "eta": 1.0, "max_var": 1.0,
                "UNetParams": {
                    "image_size": 64, "in_channels": 3, "model_channels": 128,
                    "out_channels": 3, "num_res_blocks": 2,
                    "attention_resolutions": (32, 16, 8),
                    "channel_mult": (1, 4, 8), "conv_resample": True, "dims": 2,
                    "num_heads": 8, "num_head_channels": 64,
                    "use_scale_shift_norm": True, "resblock_updown": True,
                    "use_spatial_transformer": False, "context_dim": None,
                    "condition_key": "nocond",
                },
            },
        },
    },
}


def lbbdm_f4_config() -> ConfigNode:
    """A fresh ConfigNode of the LBBDM-f4 template."""
    return dict2namespace(copy.deepcopy(_LBBDM_F4))
