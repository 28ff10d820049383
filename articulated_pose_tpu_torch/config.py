"""Serving configuration.

Port of the `articulated_pose_tpu.config.NetworkConfig` fields that the
forward + pose-fit path reads, with the same names and defaults,
including the mixed-precision policy knobs (`head_compute_dtype`,
`pool_compute_dtype`, `act_compute_dtype`, `f32_stages`; docs/dtype_ab.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from articulated_pose_tpu_torch.registry import CategorySpec, get_category

DTYPE_NAMES = ("float32", "bfloat16")
_POLICY_DTYPES = ("head_compute_dtype", "pool_compute_dtype",
                  "act_compute_dtype")
# the stages f32_stages may pin (config.py:152): the presets' two-level
# backbone
F32_STAGES = ("sa1", "sa2", "sa_global", "fp1", "fp2", "fp3", "fc1")


@dataclasses.dataclass
class NetworkConfig:
    category: str = "eyeglasses"
    nocs_type: str = "ancsh"           # 'ancsh' (part+global NOCS) | 'npcs'
    n_max_parts: int = 3
    num_points: int = 1024
    pred_joint: bool = True
    early_split_nocs: bool = True
    dropout_rate: float = 0.5          # identity in eval; kept for parity
    backbone_preset: str = "reference"  # 'reference' | 'tiny'
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
    batch_size: int = 16

    ransac_niter_part: int = 128
    ransac_niter_joint: int = 64
    ransac_inlier_th: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.nocs_type not in ("ancsh", "npcs"):
            raise ValueError(
                f"nocs_type must be 'ancsh' or 'npcs', got {self.nocs_type!r}")
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


def load_config(path: Optional[str] = None, **overrides) -> NetworkConfig:
    """Load a NetworkConfig from a flat YAML mapping, applying overrides.

    Keys of the JAX package's config that serving does not read are
    ignored, so one YAML file serves both packages.
    """
    fields = {}
    if path is not None:
        import yaml

        with open(path) as f:
            fields.update(yaml.safe_load(f) or {})
    fields.update(overrides)
    known = {f.name for f in dataclasses.fields(NetworkConfig)}
    cfg = NetworkConfig(**{k: v for k, v in fields.items() if k in known})
    if cfg.nocs_type == "npcs":
        cfg = cfg.replace(pred_joint=False)
    return cfg
