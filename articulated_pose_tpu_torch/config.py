"""Serving and training configuration.

Port of the `articulated_pose_tpu.config.NetworkConfig` fields that the
forward, the pose fit, the training step, the data feed and the command
line read, with the same names and defaults, including the mixed-precision policy knobs
(`head_compute_dtype`, `pool_compute_dtype`, `act_compute_dtype`,
`f32_stages`; docs/dtype_ab.md), and the two schedules of the training
step (`bn_momentum_schedule`, `lr_schedule`).

`load_config` reads the JAX package's config files (`cfg/*.yml`) with a
small reader of its own (`read_flat_yaml`), so it needs no PyYAML, and
it refuses a key that neither package knows, as JAX's `load_config`
does.  One key is the port's alone (`PORT_FIELDS`): `backbone`, which
picks PointNet++ ("pointnet2", the JAX package's only backbone), the
Point Transformer ("point_transformer", `models/point_transformer.py`),
Point Transformer V3 ("point_transformer_v3",
`models/point_transformer_v3.py`) or MinkUNet34C ("minkunet",
`models/minkunet.py`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from articulated_pose_tpu_torch.registry import CategorySpec, get_category

DTYPE_NAMES = ("float32", "bfloat16")
_POLICY_DTYPES = ("head_compute_dtype", "pool_compute_dtype",
                  "act_compute_dtype")
# the stages f32_stages may pin (config.py:152): the presets' two-level
# backbone
F32_STAGES = ("sa1", "sa2", "sa_global", "fp1", "fp2", "fp3", "fc1")
# every field of the JAX package's NetworkConfig (config.py:19-118), in
# its order: a config file may name any of them, and load_config ignores
# those the port does not read; any other key is refused, as there
JAX_FIELDS = (
    "nn_name", "category", "nocs_type", "experiment_dir", "n_max_parts",
    "num_points", "pred_joint", "pred_joint_ind", "early_split_nocs",
    "dropout_rate", "backbone_preset", "compute_dtype", "head_compute_dtype",
    "pool_compute_dtype", "act_compute_dtype", "f32_stages", "use_pallas",
    "ball_query_packed", "miou_loss_multiplier", "nocs_loss_multiplier",
    "gocs_loss_multiplier", "offset_loss_multiplier",
    "orient_loss_multiplier", "index_loss_multiplier",
    "total_loss_multiplier", "coord_regress_loss", "batch_size", "n_epochs",
    "init_learning_rate", "decay_step", "decay_rate", "bn_decay_step",
    "val_interval", "snapshot_interval", "val_prediction_n_keep",
    "writer_start_step", "data_root", "num_expr", "train_data_add_noise",
    "fixed_order_val", "thres_r", "ransac_niter_part", "ransac_niter_joint",
    "ransac_inlier_th", "lm_iters", "use_gt_joint_association",
    "mesh_shape", "seed")
# the keys only the port knows, which load_config accepts beside JAX's
PORT_FIELDS = ("backbone",)
BACKBONES = ("pointnet2", "point_transformer", "point_transformer_v3",
             "minkunet")


@dataclasses.dataclass
class NetworkConfig:
    nn_name: str = "ancsh"
    category: str = "eyeglasses"
    nocs_type: str = "ancsh"           # 'ancsh' (part+global NOCS) | 'npcs'
    experiment_dir: str = "results"
    n_max_parts: int = 3
    num_points: int = 1024
    pred_joint: bool = True
    pred_joint_ind: bool = True
    early_split_nocs: bool = True
    dropout_rate: float = 0.5          # the backbone's dp1, in training
    backbone_preset: str = "reference"  # 'reference' | 'tiny'
    backbone: str = "pointnet2"        # one of BACKBONES (the port's key)
    compute_dtype: str = "float32"     # 'float32' | 'bfloat16' trunk
    # mixed-precision policy under a bf16 trunk (None = compute_dtype):
    # the heads' dtype; what each SA stage's last layer emits and pools
    # in; what every backbone layer emits
    head_compute_dtype: Optional[str] = None
    pool_compute_dtype: Optional[str] = None
    act_compute_dtype: Optional[str] = None
    # backbone stages computed in f32 whatever compute_dtype says
    f32_stages: tuple = ()
    # the JAX package's kernel-tier switches (config.py:66,73): with
    # use_pallas the ball query takes the "pallas" route, where
    # ball_query_packed selects the 10-bit-quantised coordinate tier;
    # without it the "xla" route, exact whatever ball_query_packed says
    use_pallas: bool = True
    ball_query_packed: bool = False

    # losses (config.py:77-85)
    miou_loss_multiplier: float = 1.0
    nocs_loss_multiplier: float = 10.0
    gocs_loss_multiplier: float = 1.0
    offset_loss_multiplier: float = 5.0    # heatmap & unitvec
    orient_loss_multiplier: float = 0.2
    index_loss_multiplier: float = 1.0
    total_loss_multiplier: float = 1.0
    coord_regress_loss: str = "L2"     # 'L2' | 'Soft_L1' | 'L1'

    # schedule (config.py:88-97): decay steps count samples
    batch_size: int = 16
    n_epochs: int = 1000
    init_learning_rate: float = 1e-3
    decay_step: int = 200_000
    decay_rate: float = 0.7
    bn_decay_step: int = 200_000
    val_interval: int = 5000
    snapshot_interval: int = 1000
    val_prediction_n_keep: int = 2

    # data (config.py:99-109)
    data_root: str = "data"
    num_expr: str = "0.01"
    train_data_add_noise: bool = False
    thres_r: float = 0.2               # joint-association radius

    ransac_niter_part: int = 128
    ransac_niter_joint: int = 64
    ransac_inlier_th: float = 0.1
    use_gt_joint_association: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.nocs_type not in ("ancsh", "npcs"):
            raise ValueError(
                f"nocs_type must be 'ancsh' or 'npcs', got {self.nocs_type!r}")
        if self.backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {BACKBONES}, got "
                             f"{self.backbone!r}")
        if self.compute_dtype not in DTYPE_NAMES:
            raise ValueError(
                f"compute_dtype must be float32 or bfloat16, got "
                f"{self.compute_dtype!r}")
        for name in _POLICY_DTYPES:
            if getattr(self, name) not in (None,) + DTYPE_NAMES:
                raise ValueError(f"{name} must be None, float32 or bfloat16, "
                                 f"got {getattr(self, name)!r}")
        # a silently ignored typo would undo the pin this field exists
        # for: strip, make a tuple, raise on an unknown name, as JAX's
        # load_config does (config.py:146-155)
        stages = tuple(str(s).strip() for s in self.f32_stages)
        bad = [s for s in stages if s not in F32_STAGES]
        if bad:
            raise ValueError(
                f"unknown f32_stages {bad}; valid: {sorted(F32_STAGES)}")
        self.f32_stages = stages

    @property
    def is_mixed(self) -> bool:
        """ANCSH mode regresses part + global NOCS."""
        return self.nocs_type == "ancsh"

    @property
    def category_spec(self) -> CategorySpec:
        return get_category(self.category)

    def replace(self, **kw) -> "NetworkConfig":
        return dataclasses.replace(self, **kw)


# the YAML 1.1 scalars PyYAML resolves (its resolver.py), as far as the
# JAX configs use them; anything else unquoted is a plain string
_BOOLS = {w: v for v, words in ((True, "yes true on"), (False, "no false off"))
          for word in words.split() for w in (word, word.title(),
                                               word.upper())}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
# decimal floats with a point or an exponent, `1e-3` included (PyYAML
# reads that one as a string; the reader takes the number it means)
_FLOAT = re.compile(r"[-+]?(([0-9][0-9_]*)?\.[0-9_]*([eE][-+]?[0-9]+)?"
                    r"|[0-9][0-9_]*[eE][-+]?[0-9]+)")
_SPECIAL_FLOATS = {".inf": float("inf"), "+.inf": float("inf"),
                   "-.inf": float("-inf"), ".nan": float("nan")}
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(\s+(.*))?$")
# a plain scalar may not start with YAML's indicators: flow collections,
# anchors, aliases, tags, block scalars, directives, reserved characters
_INDICATORS = "[]{}&*!|>%@`,?:-#"


def _strip_comment(line: str) -> str:
    """The line without a trailing `# ...` comment outside quotes."""
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


def _scalar(text: str, where: str):
    """One scalar of a flat config: quoted or bare string, bool, int,
    float or null, resolved as PyYAML resolves it."""
    text = text.strip()
    if text and text[0] in "'\"":
        quote = text[0]
        if len(text) < 2 or text[-1] != quote:
            raise ValueError(f"{where}: unterminated string {text!r}")
        body = text[1:-1]
        if quote == "'":
            if "'" in body.replace("''", ""):
                raise ValueError(f"{where}: stray quote in {text!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in {text!r} are not read")
        return body
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if text.lower() in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text.lower()]
    if _FLOAT.fullmatch(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    # what starts like a number but is none of the above (octal, hex,
    # sexagesimal, a date) PyYAML reads as something else: refused
    if (text[0] in _INDICATORS or ": " in text or " #" in text
            or re.match(r"[-+]?\.?[0-9]", text)):
        raise ValueError(f"{where}: cannot read {text!r} as a scalar of a "
                         "flat config")
    return text


def _flow_list(text: str, where: str) -> list:
    """`[a, 'b', 1]`: a flow list of scalars (no nesting)."""
    body = text[1:-1]
    items, item, quote = [], "", None
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested collection in {text!r}")
        elif ch == ",":
            items.append(item)
            item = ""
            continue
        item += ch
    if quote:
        raise ValueError(f"{where}: unterminated string in {text!r}")
    items.append(item)
    if len(items) == 1 and not items[0].strip():
        return []
    if not all(i.strip() for i in items):
        raise ValueError(f"{where}: empty item in {text!r}")
    return [_scalar(i, where) for i in items]


def read_flat_yaml(text: str, name: str = "<config>") -> dict:
    """Parse the YAML the JAX configs are written in: a flat mapping of
    `key: value` lines, each value a scalar (quoted or bare string, bool,
    int, float, null), a `[a, b]` flow list, or a block list of `- a`
    lines under an empty `key:`.  Comments and blank lines are skipped.
    Anything else (a nested mapping, a flow mapping, anchors, tags,
    multi-line scalars, a repeated key) raises ValueError: the reader
    does not guess.  Needs no PyYAML, which the card host lacks."""
    out = {}
    block = None                        # the key whose `- item` lines follow
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}: tab in indentation")
        stripped = line.strip()
        if stripped == "-" or stripped.startswith("- "):
            if block is None:
                raise ValueError(f"{where}: list item outside a list")
            item = stripped[1:].strip()
            if not item or item[0] in "[{" or _KEY.match(item):
                raise ValueError(f"{where}: nested item {item!r}")
            if out[block] is None:
                out[block] = []
            out[block].append(_scalar(item, where))
            continue
        if line[0] in " ":
            raise ValueError(f"{where}: indented line {stripped!r}: not a "
                             "flat mapping")
        block = None
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"{where}: expected `key: value`, got {line!r}")
        key, value = m.group(1), (m.group(3) or "").strip()
        if key in out:
            raise ValueError(f"{where}: repeated key {key!r}")
        if not value:
            out[key] = None             # null, unless `- item` lines follow
            block = key
        elif value[0] == "[" and value[-1] == "]":
            out[key] = _flow_list(value, where)
        else:
            out[key] = _scalar(value, where)
    return out


def load_config(path: Optional[str] = None, **overrides) -> NetworkConfig:
    """Load a NetworkConfig from a JAX config file (a flat YAML mapping,
    read by `read_flat_yaml`), applying overrides.

    Keys of the JAX package's config that serving does not read are
    ignored, so one file serves both packages; `PORT_FIELDS` are the
    port's own; a key of neither raises ValueError, from the file or
    from the overrides, as JAX does (config.py:141-144).
    """
    fields = {}
    if path is not None:
        with open(path) as f:
            fields.update(read_flat_yaml(f.read(), str(path)))
    fields.update(overrides)
    unknown = set(fields) - set(JAX_FIELDS) - set(PORT_FIELDS)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    known = {f.name for f in dataclasses.fields(NetworkConfig)}
    cfg = NetworkConfig(**{k: v for k, v in fields.items() if k in known})
    if cfg.nocs_type == "npcs":
        cfg = cfg.replace(pred_joint=False, pred_joint_ind=False)
    return cfg


def bn_momentum_schedule(step, batch_size: int, bn_decay_step: int
                         ) -> torch.Tensor:
    """EMA momentum of the batch-norm statistics at `step`:
    min(0.99, 1 - 0.5 * 0.5^floor(step * B / bn_decay_step)), in float32
    (config.py:163-174).  `step` is a Python int or an integer tensor;
    the result is a 0-d float32 tensor on the step's device."""
    samples = torch.as_tensor(step) * batch_size
    bn_momentum = 0.5 * torch.pow(0.5, torch.floor(samples / bn_decay_step))
    return torch.clamp_max(1.0 - bn_momentum, 0.99)


def lr_schedule(step, batch_size: int, init_lr: float, decay_step: int,
                decay_rate: float) -> torch.Tensor:
    """Staircase learning rate in units of samples:
    init_lr * decay_rate^floor(step * B / decay_step), in float32
    (config.py:177-182); `step` as in `bn_momentum_schedule`."""
    samples = torch.as_tensor(step) * batch_size
    return init_lr * torch.pow(decay_rate, torch.floor(samples / decay_step))
