"""Typed, frozen, hashable configuration tree of the PyTorch port.

The port's own copy of the JAX package's ``config`` module, field for
field (``tests/test_torch_host.py`` holds the two equal on every
``cfgs/*.yml``).  It replaces the reference's global ``cfg`` EasyDict
(``lib/model/utils/config.py:~40`` upstream layout) + per-net YAML overlays
(``cfgs/vgg16.yml``).  Every config object is a frozen dataclass, so a
config is hashable and the whole pipeline (shapes, top-K sizes, loop
bounds) is fixed when a model is built.

Knob names mirror the reference (lowercased) so diffs are auditable:
``TRAIN.RPN_PRE_NMS_TOP_N`` -> ``cfg.train.rpn_pre_nms_top_n`` and so on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Leaf configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AnchorConfig:
    """Anchor generation (ref: lib/model/rpn/generate_anchors.py:~10)."""

    base_size: int = 16
    scales: Tuple[float, ...] = (8.0, 16.0, 32.0)   # ref cfg.ANCHOR_SCALES
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)     # ref cfg.ANCHOR_RATIOS

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclass(frozen=True)
class ProposalConfig:
    """Proposal layer knobs (ref: lib/model/rpn/proposal_layer.py:~60).

    Static-shape rethink: the reference sorts a *dynamic* number of anchors,
    keeps ``pre_nms_top_n``, NMS-es to a dynamic count, then slices
    ``post_nms_top_n``.  Here every stage has a fixed size and carries a
    validity mask instead.
    """

    pre_nms_top_n: int = 12000    # ref TRAIN.RPN_PRE_NMS_TOP_N
    post_nms_top_n: int = 2000    # ref TRAIN.RPN_POST_NMS_TOP_N
    nms_thresh: float = 0.7       # ref TRAIN.RPN_NMS_THRESH
    min_size: float = 8.0         # ref TRAIN.RPN_MIN_SIZE


@dataclass(frozen=True)
class RPNTargetConfig:
    """Anchor target assignment (ref: lib/model/rpn/anchor_target_layer.py:~50)."""

    batch_size: int = 256            # ref TRAIN.RPN_BATCHSIZE
    fg_fraction: float = 0.5         # ref TRAIN.RPN_FG_FRACTION
    positive_overlap: float = 0.7    # ref TRAIN.RPN_POSITIVE_OVERLAP
    negative_overlap: float = 0.3    # ref TRAIN.RPN_NEGATIVE_OVERLAP
    clobber_positives: bool = False  # ref TRAIN.RPN_CLOBBER_POSITIVES
    positive_weight: float = -1.0    # ref TRAIN.RPN_POSITIVE_WEIGHT


@dataclass(frozen=True)
class ROITargetConfig:
    """RoI sampling for the RCNN head
    (ref: lib/model/rpn/proposal_target_layer_cascade.py:~40)."""

    batch_size: int = 128                  # ref TRAIN.BATCH_SIZE (rois/img)
    fg_fraction: float = 0.25              # ref TRAIN.FG_FRACTION
    fg_thresh: float = 0.5                 # ref TRAIN.FG_THRESH
    bg_thresh_hi: float = 0.5              # ref TRAIN.BG_THRESH_HI
    bg_thresh_lo: float = 0.0              # ref TRAIN.BG_THRESH_LO
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    bbox_inside_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)


_TRUNKS = {"vgg16": ("vgg16", None), "tiny": ("tiny", None),
           **{f"resnet{d}": ("resnet", d) for d in (50, 101, 152)},
           **{f"resnet{d}_fpn": ("resnet_fpn", d) for d in (50, 101, 152)}}


def parse_backbone(name: str) -> Tuple[str, Optional[int]]:
    """The one reader of a backbone name: its family (``vgg16``, ``tiny``,
    ``resnet``, a C4 detector, or ``resnet_fpn``, a feature pyramid) and
    its ResNet depth (None for the first two); ValueError for others."""
    try:
        return _TRUNKS[name]
    except KeyError:
        raise ValueError(f"unknown backbone {name!r}; accepted: "
                         f"{', '.join(_TRUNKS)}") from None


@dataclass(frozen=True)
class ModelConfig:
    """Detector architecture (ref: lib/model/faster_rcnn/faster_rcnn.py:~20)."""

    backbone: str = "vgg16"          # one of parse_backbone's names
    num_classes: int = 9             # cityscapes: 8 fg + background
    feat_stride: int = 16
    rpn_channels: int = 512
    # ref cfg.POOLING_MODE. "align" = torchvision-spec RoIAlign;
    # "align_legacy" = the reference CUDA kernel's crop-and-resize
    # semantics (use with converted reference weights); "pool" | "crop".
    pooling_mode: str = "align"
    pooling_size: int = 7            # ref cfg.POOLING_SIZE
    sampling_ratio: int = 2          # RoIAlign samples per bin edge;
                                     # 0 = torchvision adaptive rule
    # The JAX package's kernel switches, kept so that one YAML file
    # configures both packages.  The port reads none of the three: its
    # RoI-Align contraction, VGG stem and bottleneck chain always run
    # through their wrappers in ``ops/kernels`` (the CUDA kernel on a
    # CUDA tensor, the plain twin on a CPU tensor).
    roi_pallas: bool = False
    stem_pallas: bool = True
    bottleneck_pallas: bool = False
    # ResNet RoI-head (layer4) convs as explicit matrix products (1x1s
    # as (R*H*W, C) matmuls, the 3x3 as a stacked-9-tap matmul) in the
    # JAX package; opt-in there.
    head_matmul: bool = False
    class_agnostic: bool = False
    truncated_init: bool = False     # ref TRAIN.TRUNCATED
    compute_dtype: str = "bfloat16"  # matmul/conv dtype
    # ResNet-specific (ref: lib/model/faster_rcnn/resnet.py:~250)
    resnet_fixed_blocks: int = 1     # ref RESNET.FIXED_BLOCKS
    # Multi-scale RoI alignment (BASELINE config #5 stretch): small rois
    # pool from the stride-8 backbone level (lateral 1x1-projected to the
    # head's channel count), large rois from stride 16.  RPN stays on the
    # stride-16 map.
    multiscale_roi: bool = False
    ms_fine_threshold: float = 112.0  # roi sqrt-area (image px) cutoff
    # Apply the lateral projection AFTER RoI-align instead of to the full
    # stride-8 map.  A 1x1 conv (linear over channels) commutes exactly
    # with RoI-align (linear over space): align(proj(f)) = align(f) @ W
    # + b * (sum_h wy)(sum_w wx) — see FasterRCNN.pool_multiscale.  This
    # halves the align's intermediate (contracts at C=512 instead of
    # the projected 1024) and deletes the full-map projection pass.
    # Opt-in.
    ms_proj_after_pool: bool = False


@dataclass(frozen=True)
class AdaptConfig:
    """SCDA-specific knobs (region mining + adversarial alignment).

    Ref: the fork's adaptation trainer (SURVEY.md §2b/§3.2) and the CVPR'19
    paper §3.  K-means runs on-device with fixed iteration count.
    """

    enabled: bool = False
    num_groups: int = 9             # K in region mining (paper: ~#objects prior)
    kmeans_iters: int = 10          # fixed number of iterations
    # Mining k-means init: "++" (D²-spread, sklearn-default parity) or
    # "spread" (legacy quantile-strided; kept selectable so the init's
    # effect on adaptation is A/B-able — scripts/kmeans_init_ab.py).
    kmeans_init: str = "++"
    mining_top_n: int = 300         # proposals fed to k-means
    region_pool_size: int = 7       # pooled patch side for discriminator
    adv_weight: float = 0.1         # lambda on the alignment loss
    grl_weight: float = 1.0         # gradient reversal scale
    d_lr: float = 1e-3              # discriminator optimizer lr
    d_channels: int = 256           # discriminator width
    # Discriminator update schedule:
    #   "joint"       — DANN single-loss: one BCE with true domain labels,
    #                   detector receives the reversed gradient (GRL).
    #   "alternating" — GAN-style two-loss: D descends BCE with true
    #                   labels on detached patches; the detector descends
    #                   BCE with FLIPPED labels through a frozen D
    #                   (non-saturating adversarial loss).  De-risks the
    #                   fork's D/G-step trainer (SURVEY.md §3.2, verify).
    d_update: str = "joint"         # joint | alternating


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + schedule (ref: trainval_net.py:~80 flags and
    lib/model/utils/config.py TRAIN.* defaults)."""

    learning_rate: float = 1e-3      # ref TRAIN.LEARNING_RATE
    momentum: float = 0.9            # ref TRAIN.MOMENTUM
    # Momentum-buffer dtype: "bfloat16" halves the optimizer-state
    # traffic of the 411 MB fc6 weight; "float32" is the reference-exact
    # default.
    momentum_dtype: str = "float32"  # float32 | bfloat16
    weight_decay: float = 5e-4       # ref TRAIN.WEIGHT_DECAY
    double_bias: bool = True         # ref TRAIN.DOUBLE_BIAS (2x lr, no decay)
    bias_decay: bool = False         # ref TRAIN.BIAS_DECAY
    gamma: float = 0.1               # ref lr decay factor
    lr_decay_step: int = 5           # epochs between decays
    # Ref freezes conv1-2 (VGG) / conv1+layer1 (ResNet) because they are
    # caffe-pretrained; when training from scratch freezing random
    # filters just hurts — set False then.
    freeze_pretrained_layers: bool = True
    max_epochs: int = 7
    batch_size: int = 1              # images per step (per replica)
    clip_gradients: float = 10.0     # ref net_utils.clip_gradient (vgg16 path)
    proposal: ProposalConfig = field(default_factory=ProposalConfig)
    rpn_target: RPNTargetConfig = field(default_factory=RPNTargetConfig)
    roi_target: ROITargetConfig = field(default_factory=ROITargetConfig)
    seed: int = 3                    # ref default --s / RNG_SEED
    disp_interval: int = 100
    checkpoint_interval: int = 0     # steps; 0 = per-epoch (ref behaviour)


@dataclass(frozen=True)
class TestConfig:
    """Inference-time knobs (ref: lib/model/utils/config.py TEST.* and
    test_net.py:~150)."""

    proposal: ProposalConfig = field(
        default_factory=lambda: ProposalConfig(
            pre_nms_top_n=6000, post_nms_top_n=300, nms_thresh=0.7,
            min_size=16.0,
        )
    )
    nms_thresh: float = 0.3          # ref TEST.NMS (per-class test NMS)
    score_thresh: float = 0.05       # test_net.py thresh
    max_per_image: int = 100         # test_net.py max_per_image
    max_dets_per_class: int = 100    # static per-class NMS output size
    bbox_reg: bool = True            # ref TEST.BBOX_REG
    # Serve with bfloat16 weights: halves the weights' memory traffic.
    # Off by default for bit-parity with training evals.
    bf16_weights: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline (ref: lib/roi_data_layer/* + cfg scales).

    Static-shape rethink of the reference's ratio-grouped dynamic batching:
    images are scaled with the reference rule (shorter side -> ``scale``,
    longer side capped at ``max_size``) then placed top-left into a fixed
    ``image_size`` canvas with a validity extent recorded in ``im_info``.
    """

    scale: int = 600                 # ref cfg.TRAIN.SCALES = (600,)
    max_size: int = 1000             # ref cfg.TRAIN.MAX_SIZE
    image_size: Tuple[int, int] = (512, 1024)  # padded canvas (H, W), /16
    # Portrait images get the transposed canvas (and batches bucket by
    # orientation) so the shorter-side scale rule holds for every image
    # — the static-shape analog of the ref's aspect-ratio grouping.
    orientation_aware: bool = True
    # CLIs derive image_size from the dataset's records (infer_canvas)
    # for registered real datasets; set False to pin image_size.
    auto_canvas: bool = True
    max_gt_boxes: int = 50           # ref roibatchLoader gt padding
    pixel_means: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)  # BGR, caffe
    use_flipped: bool = True         # ref cfg.TRAIN.USE_FLIPPED
    num_workers: int = 8             # decode threads (0 = single thread)
    cache_mb: int = 512              # decoded-image (uint8) cache budget
    # Derived-canvas alignment: 16 is the feature-stride minimum; 32
    # (default) makes infer_canvas reproduce the benchmarked presets
    # (e.g. Cityscapes 500x1000 content -> 512x1024, not 512x1008).
    canvas_align: int = 32
    # Optional on-disk preprocessed-image cache directory ("" = off):
    # RESIZED uint8 images (~1.5 MB/record) are stored once and
    # mmap-read thereafter (float conversion + mean-subtract happen at
    # use time), so real-dataset-scale splits feed the device at rate
    # on a 1-core host — the in-RAM u8 cache cannot hold a full
    # Cityscapes split.  See data/pipeline.py:CanvasDiskCache.
    canvas_cache_dir: str = ""


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh / sharding (replaces ref nn.DataParallel, SURVEY.md §2c)."""

    data_axis: str = "data"
    num_devices: int = 0             # 0 = all visible devices


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    data: DataConfig = field(default_factory=DataConfig)
    adapt: AdaptConfig = field(default_factory=AdaptConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)


# ---------------------------------------------------------------------------
# Construction / override helpers (ref: cfg_from_file / cfg_from_list)
# ---------------------------------------------------------------------------


def _coerce(value: Any, target: Any) -> Any:
    """Coerce ``value`` (possibly a string from the CLI) to the type of
    ``target``."""
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        elt = target[0] if target else 1.0
        return tuple(type(elt)(v) for v in value)
    if isinstance(target, str):
        return str(value)
    return value


def replace_path(cfg: Any, dotted: str, value: Any) -> Any:
    """Return a copy of ``cfg`` with ``dotted`` path (e.g.
    ``train.proposal.nms_thresh``) replaced by ``value``.

    Analog of ``cfg_from_list`` (ref lib/model/utils/config.py:~330):
    instead of mutating a global EasyDict we functionally rebuild the frozen
    tree, so the updated config hashes differently and triggers a re-trace.
    """
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"config has no field {head!r} (path {dotted!r})")
    current = getattr(cfg, head)
    if rest:
        new_child = replace_path(current, rest, value)
        return dataclasses.replace(cfg, **{head: new_child})
    return dataclasses.replace(cfg, **{head: _coerce(value, current)})


def parse_set_list(tokens) -> dict:
    """Parse CLI ``--set`` tokens into an overrides dict.

    Accepts the reference's pair form (``--set a.b 1 c.d 2`` —
    cfg_from_list parity, ref lib/model/utils/config.py:~330) and
    ``key=value`` tokens, mixed freely.  A dangling key RAISES instead
    of being silently dropped: the old ``dict(zip(l[0::2], l[1::2]))``
    swallowed odd-length lists, turning a mistyped ``--set k=v`` into a
    silent no-op (caught when an A/B counterfactual arm trained
    bit-identically to its control)."""
    out: dict = {}
    toks = list(tokens)
    i = 0
    while i < len(toks):
        tok = toks[i]
        if "=" in tok:
            key, _, value = tok.partition("=")
            out[key] = value
            i += 1
        else:
            if i + 1 >= len(toks):
                raise SystemExit(
                    f"--set: missing value for config key {tok!r} "
                    f"(use 'path value' pairs or 'path=value')")
            out[tok] = toks[i + 1]
            i += 2
    return out


def apply_overrides(cfg: Config, overrides: Mapping[str, Any]) -> Config:
    for key, value in overrides.items():
        cfg = replace_path(cfg, key, value)
    return cfg


def _merge_into(node: Any, mapping: Mapping[str, Any]) -> Any:
    for key, value in mapping.items():
        current = getattr(node, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            node = dataclasses.replace(node, **{key: _merge_into(current, value)})
        else:
            node = dataclasses.replace(node, **{key: _coerce(value, current)})
    return node


def config_from_yaml(path: str, base: Config | None = None) -> Config:
    """Load a YAML overlay onto the defaults (ref ``cfg_from_file``,
    lib/model/utils/config.py:~300)."""
    import yaml

    with open(path) as f:
        payload = yaml.safe_load(f) or {}
    cfg = base if base is not None else Config()
    return _merge_into(cfg, payload)


# Named presets mirroring the reference's cfgs/*.yml -------------------------


def vgg16_config() -> Config:
    """Equivalent of ref cfgs/vgg16.yml."""
    return Config(model=ModelConfig(backbone="vgg16"))


def res101_config() -> Config:
    """Equivalent of ref cfgs/res101.yml."""
    return Config(
        model=ModelConfig(backbone="resnet101"),
        train=TrainConfig(double_bias=False, weight_decay=1e-4),
    )


def res50_config() -> Config:
    """Equivalent of ref cfgs/res50.yml (same knobs as res101 at depth
    50 — the canonical faster-rcnn.pytorch layout ships one ResNet
    recipe per depth)."""
    return Config(
        model=ModelConfig(backbone="resnet50"),
        train=TrainConfig(double_bias=False, weight_decay=1e-4),
    )


def res152_config() -> Config:
    """Equivalent of ref cfgs/res152.yml."""
    return Config(
        model=ModelConfig(backbone="resnet152"),
        train=TrainConfig(double_bias=False, weight_decay=1e-4),
    )


def res101_fpn_config() -> Config:
    """ResNet-101-FPN Faster R-CNN, the port's own preset (the JAX package
    has no FPN): Detectron's ``e2e_faster_rcnn_R-101-FPN_1x.yaml`` at one
    GPU's share of its 8 x 2 images (2 images a step, the learning rate
    scaled linearly from 0.02 to 0.0025, one decay at step 60000 where
    Detectron decays at 60000 and 80000) on Cityscapes' full 1024x2048
    frame.  The pyramid's widths
    and level rules are :mod:`scda_tpu_torch.models.fpn`'s constants;
    ``proposal.pre/post_nms_top_n`` count per level and ``post_nms_top_n``
    is also the collect's count; each level's anchors take its stride as
    their base size."""
    return Config(
        model=ModelConfig(backbone="resnet101_fpn", rpn_channels=256),
        train=TrainConfig(
            learning_rate=0.0025, weight_decay=1e-4, double_bias=True,
            bias_decay=False, batch_size=2, lr_decay_step=60, max_epochs=90,
            proposal=ProposalConfig(pre_nms_top_n=2000, post_nms_top_n=2000,
                                    nms_thresh=0.7, min_size=0.0),
            roi_target=ROITargetConfig(batch_size=512)),
        test=TestConfig(
            proposal=ProposalConfig(pre_nms_top_n=1000, post_nms_top_n=1000,
                                    nms_thresh=0.7, min_size=0.0),
            nms_thresh=0.5),
        data=DataConfig(scale=1024, max_size=2048, image_size=(1024, 2048)),
        anchors=AnchorConfig(scales=(8.0,)),
    )


PRESETS = {
    "vgg16": vgg16_config,
    "res101": res101_config,
    "res50": res50_config,
    "res152": res152_config,
    "res101_fpn": res101_fpn_config,
}


def get_config(preset: str = "vgg16", **overrides: Any) -> Config:
    cfg = PRESETS[preset]()
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
