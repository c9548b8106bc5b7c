"""Typed VMG network, training and evaluation configuration, without YAML.

Mirrors the architecture fields, derived properties and presets of
``vmg_tpu.configs.config.VMGNetworkConfig`` and the fields of its
``DatasetConfig``, ``TrainConfig``, ``LoggerConfig``, ``PathConfig`` and
``ExperimentConfig``, with the JAX package's five evaluation presets
(:data:`EVAL_PRESETS`) and four training presets (:data:`TRAIN_PRESETS`)
as Python values.  ``remat`` recomputes each
TAB and each trajectory step in the backward pass
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint``
does.  ``flow_levels`` is the serving mode of the flow pyramid:
``'per_level'`` reruns SPyNet on every level, ``'shared'`` runs it at
level 0 only and average-pools that flow down.  The JAX package's
TPU-only knobs (remat_policy, morph_fused, stage_barrier) have no meaning
in the PyTorch port and are left out; the YAML loader stays in the JAX package (it imports ``yaml``,
which the GPU machine lacks).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


FLOW_LEVELS = ("per_level", "shared")


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
    # 'per_level' reruns SPyNet on every pyramid level (the reference's
    # semantics); 'shared' computes the level-0 flow once and average-pools
    # it down, halving the flow values a level (fewer SPyNet runs, near-
    # identical fields) -- opt-in
    flow_levels: str = "per_level"
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
    # the axis FCs' formulation in the JAX package (block-diagonal matmul or
    # token reshape): one function; the port computes the token form
    morph_fused: bool = True
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
        if self.flow_levels not in FLOW_LEVELS:
            raise ValueError(f"flow_levels must be one of {FLOW_LEVELS}, got "
                             f"{self.flow_levels!r}")

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
    run (``vmg_tpu.configs.config.TrainConfig``)."""

    lr: float = 2e-4
    lr_scheme: str = "CosineAnnealingLR_Restart"
    beta1: float = 0.9
    beta2: float = 0.99
    niter: int = 600000
    warmup_iter: int = -1
    T_period: Tuple[int, ...] = (600000,)
    restarts: Optional[Tuple[int, ...]] = None
    restart_weights: Tuple[float, ...] = (1.0,)
    eta_min: float = 1e-7
    val_freq: int = 5000
    manual_seed: int = 0
    amp: bool = False  # bf16 compute on float32 master weights
    grad_acc: bool = True  # accumulate total_batch // batch_size loader draws an update
    if_grad_clip: bool = False
    grad_clip_up: float = 0.5
    revise_epoch: bool = True
    pre_training: bool = True  # SPyNet group at pre_lr_ratio * lr
    pre_lr_ratio: float = 0.125
    weight_decay: Optional[float] = None  # on the mlp_blocks parameters
    f_u_params: bool = False
    eps: float = 1e-12  # Charbonnier epsilon (inside the sqrt)
    if_aux: bool = True
    aux_ratio: float = 0.005
    reduced_iter: Optional[int] = None

    def __post_init__(self):
        for f in ("lr", "eta_min", "eps", "aux_ratio", "pre_lr_ratio",
                  "grad_clip_up", "beta1", "beta2"):
            setattr(self, f, float(getattr(self, f)))
        if self.weight_decay is not None:
            self.weight_decay = float(self.weight_decay)
        self.niter = int(self.niter)
        self.val_freq = int(float(self.val_freq))


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


@dataclass
class DatasetConfig:
    """A training dataset's or an evaluation protocol's settings (the JAX
    package's ``DatasetConfig``)."""

    name: str = "REDS"
    mode: str = "train"
    dataroot_HR: Optional[str] = None  # training HR frames (packed, LMDB or PNG tree)
    dataroot_LR: Optional[str] = None
    cache_keys: Optional[str] = None  # pickle of {"keys": clip keys}
    dataset_root: Optional[str] = None  # eval LR root
    gt_root: Optional[str] = None  # eval GT root (default: by name, see vmg_tpu_torch.eval)
    num_frames: int = 16  # frames a training sample / a test clip
    num_out_frames: int = 100  # frames a scoring window (index_generation)
    use_shuffle: bool = True
    n_workers: int = 4
    batch_size: int = 8  # clips a loader draw
    total_batch: int = 8  # clips an update (grad_acc = total_batch // batch_size)
    crop_size: int = 256  # HR crop
    image_shape: Tuple[int, int, int] = (3, 720, 1280)  # HR / GT (C, H, W)
    image_shape_r: Tuple[int, int, int] = (3, 256, 256)
    use_hflip: bool = True
    use_vflip: bool = True
    use_rot: bool = True
    use_mirrors: bool = False
    random_reverse: bool = True
    dataset_expand_ratio: int = 2
    total_num_frames: int = 100  # frames a training clip
    pre_seed: int = 0
    interval_list: Tuple[int, ...] = (1,)
    data_enhance: bool = False
    eval_mid_clip: bool = False
    selected_topk: int = 1
    overlapped_mode: str = "mid"  # small | mid | large | int
    FLOPs: bool = False
    flops_num_frames: int = 16
    wins: Optional[Tuple[int, int]] = (128, 128)
    overlapped_spatial_length: int = 20


@dataclass
class LoggerConfig:
    print_freq: int = 1000
    save_checkpoint_freq: int = 10000
    use_tb_logger: bool = False


@dataclass
class PathConfig:
    pretrain_model: Optional[str] = None
    strict_load: bool = True
    resume_state: Optional[str] = None
    output_dir: str = "./results"
    experiments_root: str = "./experiments"


@dataclass
class EvalConfig:
    checkpoint_from: str = "mine"  # mine | ST | KAIR


@dataclass
class ExperimentConfig:
    name: str = "VMG-REDS"
    scale: int = 4
    network: VMGNetworkConfig = field(default_factory=VMGNetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    logger: LoggerConfig = field(default_factory=LoggerConfig)
    path: PathConfig = field(default_factory=PathConfig)
    # parallelism: the (data, tensor) process mesh (parallel/mesh.py); a
    # tensor axis above 1 shards the wide weights (parallel/tp.py)
    mesh_shape: Tuple[int, int] = (1, 1)


def _eval_net(base: VMGNetworkConfig, window: int, image_size=(64, 64)) -> VMGNetworkConfig:
    """An evaluation preset's network: ``base`` with the trajectory window
    and clip length ``window``, no flow freeze, and the image size the
    JAX loader derives from ``image_shape_r`` / scale."""
    return dataclasses.replace(base, num_frames=window,
                               traj_win=(window,) + base.traj_win[1:], flow_fix=None,
                               image_size=image_size)


# The JAX package's evaluation presets (vmg_tpu/configs/presets/vmg_eval_*.yml):
# network, protocol and paths.  REDS4 scores clips of 50 frames, which the
# trajectory window (16 or 32) does not divide: both packages refuse that
# clip length (models/trajectory.py).
_REDS4 = dict(name="REDS4", mode="test", dataset_root="/data/REDS/val/train_sharp_bicubic",
              gt_root="/data/REDS/val/train_sharp", num_frames=50, num_out_frames=100,
              use_rot=False)
EVAL_PRESETS = {
    "reds4_full": ExperimentConfig(
        name="VMG-REDS", network=_eval_net(FULL_PRESET, 16), dataset=DatasetConfig(**_REDS4),
        path=PathConfig(pretrain_model="./experiments/VMG-REDS/ckpt",
                        output_dir="./results_reds4")),
    "reds4_few_levels": ExperimentConfig(
        name="VMG-REDS-few-levels", network=_eval_net(FEW_LEVELS_PRESET, 32),
        dataset=DatasetConfig(**_REDS4),
        path=PathConfig(pretrain_model="./experiments/VMG-REDS-few-levels/ckpt",
                        output_dir="./results_reds4")),
    "vid4": ExperimentConfig(
        name="VMG-Vid4", network=_eval_net(FULL_PRESET, 16),
        dataset=DatasetConfig(name="Vid4", mode="test", dataset_root="/data/Vid4/LR/X4",
                              gt_root="/data/Vid4/GT", num_frames=16, num_out_frames=10000,
                              image_shape=(3, 576, 704), use_rot=False),
        path=PathConfig(pretrain_model="./experiments/VMG-REDS/ckpt",
                        output_dir="./results_vid4")),
    "udm10": ExperimentConfig(
        name="VMG-Udm10", network=_eval_net(FULL_PRESET, 16),
        dataset=DatasetConfig(name="Udm10", mode="test", dataset_root="/data/UDM10/LR/X4",
                              gt_root="/data/UDM10/GT", num_frames=16, num_out_frames=32,
                              use_rot=False),
        path=PathConfig(pretrain_model="./experiments/VMG-REDS/ckpt",
                        output_dir="./results_udm10")),
    "vimeo90k": ExperimentConfig(
        name="VMG-Vimeo90K", network=_eval_net(FULL_PRESET, 14, (64, 112)),
        dataset=DatasetConfig(name="Vimeo90k_septuplet", mode="test",
                              dataset_root="/data/vimeo_septuplet/sequences_LR/slow_test",
                              gt_root="/data/vimeo_septuplet/sequences/slow_test", num_frames=7,
                              num_out_frames=7, image_shape=(3, 256, 448),
                              image_shape_r=(3, 256, 448), use_hflip=False, use_vflip=False,
                              use_rot=False, use_mirrors=True, eval_mid_clip=True),
        path=PathConfig(pretrain_model="./experiments/VMG-REDS/ckpt",
                        output_dir="./results_vimeo90k")),
}


def _tiny_train_net(width: int, traj_win: int, keyframes: int, traj_res: int,
                    flow_fix: int, image_size) -> VMGNetworkConfig:
    """The two small 3-stage networks of the demo training presets."""
    return VMGNetworkConfig(
        embed_dim=(width,) * 3, depths=(2, 2, 2), num_heads=(2, 4, 2), num_frames=traj_win,
        window_sizes=((2, 4, 4),) * 3, flow_fix=flow_fix, traj_win=(traj_win, None),
        traj_keyframes_n=(keyframes, None), traj_heads=(2, None),
        traj_res_n=(traj_res, 0, traj_res), deform_groups=(4, 8, 4),
        chunk_ratios=(0.25, 0.25), image_size=image_size)


_REDS_TRAIN = dict(name="REDS", dataroot_HR="/data/REDS/train/reds_HR.lmdb",
                   dataroot_LR="/data/REDS/train/reds_LR.lmdb",
                   cache_keys="/data/REDS/train/REDS_keys.pkl")

# The JAX package's training presets (vmg_tpu/configs/presets/vmg_reds_full.yml,
# vmg_reds_few_levels.yml, vmg_tiny_demo.yml, vmg_demo_overfit.yml) as
# ``load_config(..., is_train=True)`` reads them.  The REDS roots are the
# reference's LMDB shards; ``python -m vmg_tpu_torch.tools.train`` overrides
# them (``--dataroot-hr``, ``--dataroot-lr``, ``--cache-keys``), e.g. with
# packed trees from ``vmg_tpu_torch.tools.prepare_data``.
TRAIN_PRESETS = {
    "reds_full": ExperimentConfig(
        name="VMG-REDS", network=FULL_PRESET,
        dataset=DatasetConfig(**_REDS_TRAIN, batch_size=4, total_batch=4),
        train=TrainConfig(niter=400000, T_period=(400000,), amp=True),
        logger=LoggerConfig(use_tb_logger=True)),
    "reds_few_levels": ExperimentConfig(
        name="VMG-REDS-few-levels", network=dataclasses.replace(
            FEW_LEVELS_PRESET, traj_win=(16, None)),
        dataset=DatasetConfig(**_REDS_TRAIN, batch_size=8, total_batch=8),
        train=TrainConfig(niter=600000, T_period=(600000,), amp=True),
        logger=LoggerConfig(use_tb_logger=True)),
    "tiny_demo": ExperimentConfig(
        name="VMG-tiny-demo", network=_tiny_train_net(32, 2, 2, 2, 5, (16, 16)),
        dataset=DatasetConfig(dataroot_HR="/tmp/vmg_demo_data/hr",
                              dataroot_LR="/tmp/vmg_demo_data/lr", num_frames=2, n_workers=2,
                              batch_size=2, total_batch=2, image_shape=(3, 256, 256),
                              total_num_frames=6),
        train=TrainConfig(niter=20, T_period=(20,)),
        logger=LoggerConfig(print_freq=5),
        path=PathConfig(experiments_root="/tmp/vmg_demo_exp",
                        output_dir="/tmp/vmg_demo_results")),
    "demo_overfit": ExperimentConfig(
        name="VMG-demo-overfit", network=_tiny_train_net(48, 6, 2, 3, 50, (32, 32)),
        dataset=DatasetConfig(dataroot_HR="/tmp/vmg_demo/hr.pack",
                              dataroot_LR="/tmp/vmg_demo/lr.pack", num_frames=6, n_workers=2,
                              batch_size=2, total_batch=2, image_shape=(3, 256, 256),
                              use_hflip=False, use_vflip=False, use_rot=False,
                              random_reverse=False, dataset_expand_ratio=64,
                              total_num_frames=30),
        train=TrainConfig(lr=5e-4, niter=300, T_period=(300,), val_freq=50),
        logger=LoggerConfig(print_freq=10, save_checkpoint_freq=300),
        path=PathConfig(experiments_root="/tmp/vmg_overfit_exp",
                        output_dir="/tmp/vmg_overfit_results")),
}
