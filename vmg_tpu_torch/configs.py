"""Typed VMG network and training configuration, without YAML.

Mirrors the architecture fields, derived properties and presets of
``vmg_tpu.configs.config.VMGNetworkConfig``, and the fields of its
``TrainConfig`` that the training step reads.  ``remat`` recomputes each
TAB and each trajectory step in the backward pass
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint``
does.  The JAX package's TPU-only knobs (remat_policy, morph_fused,
stage_barrier, flow_levels) have no meaning in the PyTorch port and are
left out; the YAML loader stays in the JAX package (it imports ``yaml``,
which the GPU machine lacks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class VMGNetworkConfig:
    """Architecture of the VMG U-Net."""

    in_chans: int = 3
    embed_dim: Tuple[int, ...] = (144, 144, 144)
    depths: Tuple[int, ...] = (4, 4, 4)
    num_heads: Tuple[int, ...] = (4, 8, 4)
    num_frames: int = 6
    window_sizes: Tuple[Tuple[int, int, int], ...] = ((2, 8, 8), (4, 8, 8), (2, 8, 8))
    mlp_ratio: float = 2.0
    n_groups: int = 1
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    back_RBs: int = 0
    spynet: Optional[str] = "spynet"  # None disables flow entirely
    flow_fix: Optional[int] = 5000
    image_size: Tuple[int, int] = (64, 64)
    # temporal mixing per *encoder* stage (index i also covers mirror stage)
    ltam: bool = True
    traj_win: Tuple[Optional[int], ...] = (6, None)
    traj_keyframes_n: Tuple[Optional[int], ...] = (3, None)
    traj_heads: Tuple[Optional[int], ...] = (4, None)
    # temporal_type per enc stage: False -> trajectory, None -> window attn
    # (or identity when temporal_empty), True -> flow-guided DCN alignment
    temporal_type: Tuple[Optional[bool], ...] = (False, None)
    temporal_empty: bool = True
    traj_res_n: Tuple[int, ...] = (15, 0, 15)  # per *layer* (enc+dec)
    deform_groups: Tuple[int, ...] = (8, 16, 8)
    max_res_scale: Tuple[int, ...] = (1, 2, 1)
    spatial_type: Tuple[bool, ...] = (False, False)
    use_mdsc: bool = False
    if_concat: bool = False
    flow_smooth: bool = True
    smooth_region_range: int = 4
    ret_decay: bool = True
    non_linear: bool = True
    gating: bool = True
    if_symm: bool = True
    symm_act: str = "tanh"
    relu_scale: bool = True
    relu_scale_norm: bool = False
    ffn_type: str = "ffn_cnn"
    mixer_type: Tuple[str, ...] = ("mlps", "mlps")
    mixer_n: Tuple[Optional[int], ...] = (None, None)
    r_scaling: float = 0.1
    chunk_ratios: Tuple[float, ...] = (0.125, 0.25)
    traj_mode: str = "wins"
    twins: Tuple[int, int] = (2, 2)
    traj_scale: bool = True
    traj_refine: Optional[str] = None
    m_scaling: float = 1.0
    if_local_fuse: bool = True
    channel_mixer: str = "rcab"
    # training only: checkpoint each TAB and each trajectory step
    remat: bool = True

    def __post_init__(self):
        self.embed_dim = tuple(self.embed_dim)
        self.depths = tuple(self.depths)
        self.num_heads = tuple(self.num_heads)
        self.window_sizes = tuple(tuple(w) for w in self.window_sizes)
        self.chunk_ratios = tuple(float(r) for r in self.chunk_ratios)
        for f in ("traj_win", "traj_keyframes_n", "traj_heads",
                  "temporal_type", "traj_res_n", "deform_groups",
                  "max_res_scale", "spatial_type", "mixer_type", "mixer_n",
                  "twins", "image_size"):
            v = getattr(self, f)
            if isinstance(v, list):
                setattr(self, f, tuple(v))
        if len(self.embed_dim) != len(self.depths):
            raise ValueError("embed_dim and depths must have equal length")
        n_enc = len(self.depths) // 2 + 1
        if len(self.chunk_ratios) < n_enc:
            raise ValueError(f"need {n_enc} chunk_ratios, got {len(self.chunk_ratios)}")

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_enc_layers(self) -> int:
        return self.num_layers // 2 + 1

    @property
    def num_dec_layers(self) -> int:
        return self.num_layers // 2

    @property
    def scale_factor(self) -> int:
        """Spatial pad multiple: 2^(enc_layers - 1)."""
        return 2 ** (self.num_enc_layers - 1)


@dataclass
class TrainConfig:
    """The optimizer, schedule, precision and loss settings of a training
    step (the fields of ``vmg_tpu.configs.config.TrainConfig`` it reads)."""

    lr: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.99
    warmup_iter: int = -1
    T_period: Tuple[int, ...] = (600000,)
    restarts: Optional[Tuple[int, ...]] = None
    restart_weights: Tuple[float, ...] = (1.0,)
    eta_min: float = 1e-7
    amp: bool = False  # bf16 compute on float32 master weights
    if_grad_clip: bool = False
    grad_clip_up: float = 0.5
    pre_training: bool = True  # SPyNet group at pre_lr_ratio * lr
    pre_lr_ratio: float = 0.125
    weight_decay: Optional[float] = None  # on the mlp_blocks parameters
    eps: float = 1e-12  # Charbonnier epsilon (inside the sqrt)
    if_aux: bool = True
    aux_ratio: float = 0.005


# the defaults: the few-levels model (vmg_reds_few_levels.yml and
# vmg_eval_reds4_few_levels.yml in the JAX package's presets)
FEW_LEVELS_PRESET = VMGNetworkConfig()

FULL_PRESET = VMGNetworkConfig(
    embed_dim=(112, 224, 224, 448, 224, 224, 112),
    depths=(4, 4, 2, 2, 2, 4, 4),
    num_heads=(4, 8, 8, 16, 8, 8, 4),
    num_frames=16,
    window_sizes=(
        (2, 8, 8), (4, 8, 8), (6, 8, 8), (8, 8, 8), (6, 8, 8), (4, 8, 8), (2, 8, 8),
    ),
    mlp_ratio=6.0,
    n_groups=4,
    traj_win=(16, None, None, None),
    traj_keyframes_n=(3, None, None, None),
    traj_heads=(4, None, None, None),
    temporal_type=(False, None, None, None),
    temporal_empty=True,
    traj_res_n=(15, 0, 0, 0, 0, 0, 15),
    deform_groups=(8, 16, 16, 32),
    max_res_scale=(1, 2, 2, 4),
    spatial_type=(False, False, False, False),
    mixer_type=("mlps", "mlps", "mlps", "mlps"),
    mixer_n=(None, None, None, None),
    use_mdsc=True,
    chunk_ratios=(0.125, 0.25, 0.1875, 0.125),
    if_local_fuse=True,
    channel_mixer="rcab",
)

TINY_TEST_PRESET = VMGNetworkConfig(
    embed_dim=(32, 32, 32),
    depths=(2, 2, 2),
    num_heads=(2, 4, 2),
    num_frames=4,
    window_sizes=((2, 4, 4), (2, 4, 4), (2, 4, 4)),
    mlp_ratio=2.0,
    traj_win=(4, None),
    traj_keyframes_n=(2, None),
    traj_heads=(2, None),
    temporal_type=(False, None),
    traj_res_n=(2, 0, 2),
    image_size=(32, 32),
    chunk_ratios=(0.25, 0.25),
)
