"""``mfu.train_fpn``: the model FLOP/s of the untraced window's FPN train
steps over the bf16 peak, in %: images/s x the FPN model's train FLOPs
per image (:func:`train_flops_per_image`) / 989 TFLOP/s.

The count follows ``flops.py``'s conventions and helpers (1 MAC = 2
FLOPs; elementwise, pooling and NMS work left out; each trainable conv
and dense layer three times its forward, each frozen one once): the
trunk's conv1 .. layer3 as ``resnet_backbone_flops`` counts them, then
layer4 at stride 32, the pyramid's 1x1 laterals and 3x3 output convs on
P2 .. P5, the shared RPN head on P2 .. P6, and the MLP head (fc6, fc7,
class scores and deltas) on ``roi_target.batch_size`` rois."""

from benchmark.metrics import flops, roofline

FPN_DIM = 256
MLP_HEAD_DIM = 1024
TRUNK_CHANNELS = (256, 512, 1024, 2048)


def _ceil(d: int, s: int) -> int:
    return -(-d // s)


def train_flops_per_image(cfg, canvas_hw) -> float:
    h, w = canvas_hw
    mc = cfg.model
    depth = int(mc.backbone[len("resnet"):-len("_fpn")])
    frozen, trainable = flops.resnet_backbone_flops(
        depth, h, w, mc.resnet_fixed_blocks, split_frozen=True)
    if not cfg.train.freeze_pretrained_layers:
        frozen, trainable = 0.0, frozen + trainable
    lh, lw, cin = h // 16, w // 16, 1024
    for bi in range(flops.RESNET_DEPTHS[depth][3]):
        fl, lh, lw, cin = flops._bottleneck_flops(lh, lw, cin, 512,
                                                  2 if bi == 0 else 1)
        trainable += fl
    a = len(cfg.anchors.scales) * len(cfg.anchors.ratios)
    for i, level in enumerate((2, 3, 4, 5, 6)):
        s = 2 ** level
        fh, fw = _ceil(h, s), _ceil(w, s)
        if level <= 5:
            trainable += flops.conv_flops(fh, fw, TRUNK_CHANNELS[i], FPN_DIM, 1)
            trainable += flops.conv_flops(fh, fw, FPN_DIM, FPN_DIM, 3)
        trainable += flops.rpn_flops(fh, fw, FPN_DIM, mc.rpn_channels, a)
    rois = cfg.train.roi_target.batch_size
    p = mc.pooling_size
    trainable += (flops.dense_flops(rois, FPN_DIM * p * p, MLP_HEAD_DIM)
                  + flops.dense_flops(rois, MLP_HEAD_DIM, MLP_HEAD_DIM)
                  + flops.cls_head_flops(rois, MLP_HEAD_DIM, mc.num_classes,
                                         mc.class_agnostic))
    return frozen + 3.0 * trainable


def read(run):
    if run.kind != "train" or not run.cfg.model.backbone.endswith("_fpn"):
        return None
    per_image = train_flops_per_image(run.cfg, tuple(run.cfg.data.image_size))
    return roofline.mfu_pct(run.img_per_s, per_image)
