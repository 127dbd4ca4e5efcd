"""Detector assembly (the JAX package's ``models/yolo.py``).

``build_model(cfg, num_classes, ...)`` resolves backbone and neck by
registry name and returns a :class:`Detector` whose ``forward`` runs
[backbone -> neck -> head] on NCHW input; train mode returns (featmaps,
cls_scores, reg_distri), eval mode the decoded (B, A, 5+nc).

The registries hold every name of the JAX package's: the backbones
(``SwinTransformerV2`` is the reference's name for the CSP conv network,
``SwinTransformerV2ViT`` the genuine transformer) and the 9 necks. The
head is ``EffiDeHead``, or with ``fuse_ab`` ``EffiDeHeadFuseAB`` (anchor
priors from ``model.head.anchors_init``, else :func:`_default_anchors`), or
with ``distill_ns`` ``EffiDeHeadDistillNS``.

``representation="LearnedRepresentation"`` makes the detector take raw
event blocks: a trainable ``QuantizationLayer`` (6 bins, 12 channels) at the
sensor size of ``data.height`` x ``data.width``, then the letterbox to
``img_size`` with pad value 0 and no /255, then the backbone.

``dtype=torch.bfloat16`` is the counterpart of Flax ``dtype=jnp.bfloat16``
with float32 parameters: the forward runs under ``torch.autocast``, which
casts the weights and inputs of every convolution, linear layer and matmul
to bf16 (as a Flax ``Conv``/``Dense`` with that dtype does) and leaves the
parameters, the BatchNorm statistics and the optimizer state in float32;
BatchNorm normalises the bf16 activations with float32 statistics. Autocast
was chosen over a bf16 copy of the module because it keeps one set of
float32 weights (an EMA's or a checkpoint's load as they are) and needs no
per-module dtype plumbing. The head's decode leaves autocast to keep the
JAX promotion (:mod:`.heads`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .backbones import (
    CSPBackboneP6,
    EfficientRep,
    EfficientRep6,
    Lite_EffiBackbone,
    ResNet50Backbone,
)
from ..ops.image import letterbox_image
from .heads import EffiDeHead, EffiDeHeadDistillNS, EffiDeHeadFuseAB
from .necks import CSPRepBiFPANNeck, CSPRepBiFPANNeck_P6, Lite_EffiNeck, PANNeckUpcat

BACKBONES = {
    "SwinTransformerV2": CSPBackboneP6,  # the reference's name for it
    "CSPBackboneP6": CSPBackboneP6,
    "EfficientRep": EfficientRep,
    "EfficientRep6": EfficientRep6,
    "ResNet": ResNet50Backbone,
    "Lite_EffiBackbone": Lite_EffiBackbone,
}


def _bifpan(cls, stage_type):
    def build(in_channels, channels_list, num_repeats, basic_mode, csp_e):
        return cls(in_channels, channels_list, num_repeats, basic_mode, csp_e, stage_type)

    return build


def _upcat(levels, stage_type, backbone_entries):
    def build(in_channels, channels_list, num_repeats, basic_mode, csp_e):
        return PANNeckUpcat(in_channels, channels_list, num_repeats, levels, backbone_entries,
                            basic_mode, csp_e, stage_type)

    return build


# name -> builder(in_channels, channels_list, num_repeats, basic_mode, csp_e)
NECKS = {
    "CSPRepBiFPANNeck_P6": _bifpan(CSPRepBiFPANNeck_P6, "bepc3"),
    "RepBiFPANNeck6": _bifpan(CSPRepBiFPANNeck_P6, "rep"),
    "CSPRepBiFPANNeck": _bifpan(CSPRepBiFPANNeck, "bepc3"),
    "RepBiFPANNeck": _bifpan(CSPRepBiFPANNeck, "rep"),
    "RepPANNeck": _upcat(3, "rep", 5),
    "CSPRepPANNeck": _upcat(3, "bepc3", 5),
    "RepPANNeck6": _upcat(4, "rep", 6),
    "CSPRepPANNeck_P6": _upcat(4, "bepc3", 6),
    "Lite_EffiNeck": lambda in_channels, channels_list, num_repeats, basic_mode, csp_e:
        Lite_EffiNeck(in_channels, unified_channels=channels_list[-1]),
}
HEADS = {"EffiDeHead": EffiDeHead}


def _scale(v, multiple, divisor: int = 8):
    return math.ceil(v * multiple / divisor) * divisor


def build_backbone(name: str, in_channels: int, channels_list: Sequence[int],
                   num_repeats: Sequence[int], basic_mode: str = "conv_silu",
                   csp_e: float = 0.5, remat: bool = False,
                   space_to_depth: bool = False) -> nn.Module:
    """The backbone ``name`` as the JAX Detector builds it: ResNet and Swin
    at their fixed presets, the Lite backbone from ``channels_list[:5]``
    with half-width mids, the others from ``channels_list[:6]``."""
    cls = BACKBONES[name]
    if cls is CSPBackboneP6:
        return cls(in_channels, channels_list[:6], num_repeats[:6], basic_mode, csp_e,
                   remat=remat, space_to_depth=space_to_depth)
    if cls is ResNet50Backbone:
        return cls(in_channels)
    if cls is Lite_EffiBackbone:
        return cls(in_channels, channels_list[:5], [c // 2 for c in channels_list[:5]],
                   num_repeats[1:5])
    return cls(in_channels, channels_list[:6], num_repeats[:6])


class Detector(nn.Module):
    """backbone + neck + head, names ``backbone``/``neck``/``head`` as in the
    Flax tree; ``dtype`` float32 or bfloat16 (module docstring)."""

    def __init__(self, in_channels: int, channels_list: Sequence[int],
                 num_repeats: Sequence[int], num_classes: int,
                 head_in_channels: Sequence[int], strides=(8, 16, 32, 64),
                 reg_max: int = 16, use_dfl: bool = True, csp_e: float = 0.5,
                 basic_mode: str = "conv_silu", backbone: str = "CSPBackboneP6",
                 neck: str = "CSPRepBiFPANNeck_P6", remat: bool = False,
                 space_to_depth: bool = False, dtype: torch.dtype = torch.float32,
                 head_type: str = "effidehead",
                 anchors_init: Optional[Sequence[Sequence[float]]] = None,
                 quantization_bins: Optional[int] = None, sensor_hw=(240, 304),
                 img_size: int = 640):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.img_size = img_size
        if quantization_bins is not None:
            raise ValueError("the frozen reference has no learned representation")
        self.backbone = build_backbone(backbone, in_channels, channels_list, num_repeats,
                                       basic_mode, csp_e, remat, space_to_depth)
        self.neck = NECKS[neck](self.backbone.out_channels, channels_list, num_repeats,
                                basic_mode, csp_e)
        feat = self.neck.out_channels
        if head_type == "fuseab":
            self.head = EffiDeHeadFuseAB(num_classes, head_in_channels, feat, anchors_init,
                                         strides, reg_max, use_dfl)
        elif head_type == "distill_ns":
            self.head = EffiDeHeadDistillNS(num_classes, head_in_channels, feat, strides,
                                            reg_max)
        elif head_type == "effidehead":
            self.head = EffiDeHead(num_classes, head_in_channels, feat, strides, reg_max,
                                   use_dfl)
        else:
            raise ValueError(f"unknown head_type {head_type!r}")

    def forward(self, x):
        """``x``: (B, C, S, S) images, or an ``EventBlock`` with the learned
        representation."""
        if hasattr(self, "quantization"):
            x = letterbox_image(self.quantization(x), self.img_size, pad_value=0.0)
            x = x.permute(0, 3, 1, 2)
        if self.dtype != torch.bfloat16:  # no autocast context: FLOPs are counted on ``meta``
            return self.head(self.neck(self.backbone(x)))
        with torch.autocast(x.device.type, torch.bfloat16):
            return self.head(self.neck(self.backbone(x)))


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation from ``generator``: every conv,
    transpose-conv and dense kernel lecun-normal (truncated normal, std
    sqrt(1/fan_in)/0.8796; a grouped conv's fan-in counts its group),
    biases 0, BatchNorm and LayerNorm scale 1 / bias 0 / mean 0 / var 1,
    residual scales 1, Swin temperatures log 10, then the head's pred-conv
    constants."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = w.shape[0] * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
        for name, p in model.named_parameters():
            if name.endswith("alpha"):
                p.fill_(1.0)
            elif name.endswith("logit_scale"):
                p.fill_(math.log(10.0))
        for mod in model.modules():
            if isinstance(mod, EffiDeHead):
                mod.reset_pred_parameters()
    return model


def build_model(
    cfg: Dict,
    num_classes: int,
    num_channels: int = 12,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    fuse_ab: bool = False,
    distill_ns: bool = False,
    representation: Optional[str] = None,
    img_size: Optional[int] = None,
) -> Detector:
    """Build from an experiment-config dict (``cfg['model']`` with
    backbone/neck/head sub-dicts, ``model.remat``,
    ``model.backbone.space_to_depth``), on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; ``meta`` builds shapes only), initialised from
    ``generator`` when one is given, computing in ``dtype``; the head and
    the learned representation as the module docstring says (``img_size``
    defaults to ``data.img_size``, 640)."""
    m = cfg["model"]
    depth_mul = m.get("depth_multiple", 1.0)
    width_mul = m.get("width_multiple", 1.0)
    bb, nk, hd = m["backbone"], m["neck"], m["head"]
    for kind, name, registry in (("backbone", bb["type"], BACKBONES),
                                 ("neck", nk["type"], NECKS),
                                 ("head", hd.get("type", "EffiDeHead"), HEADS)):
        if name not in registry:
            raise ValueError(f"unknown {kind} {name!r}; known: {sorted(registry)}")
    channels = [
        _scale(c, width_mul) for c in list(bb["out_channels"]) + list(nk["out_channels"])
    ]
    repeats = [
        (max(round(r * depth_mul), 1) if r > 1 else r)
        for r in list(bb["num_repeats"]) + list(nk["num_repeats"])
    ]
    head_in = [_scale(c, width_mul) for c in hd["in_channels"]]
    strides = tuple(hd.get("strides", (8, 16, 32, 64)))
    anchors = None
    if fuse_ab:
        anchors = (tuple(tuple(a) for a in hd["anchors_init"])
                   if isinstance(hd.get("anchors_init"), (list, tuple))
                   else _default_anchors(strides))
    data = cfg.get("data", {})
    learned = representation == "LearnedRepresentation"
    with torch.device(device):
        model = Detector(
            in_channels=num_channels,
            channels_list=channels,
            num_repeats=repeats,
            num_classes=num_classes,
            head_in_channels=head_in,
            strides=strides,
            reg_max=hd.get("reg_max", 16),
            use_dfl=hd.get("use_dfl", True),
            csp_e=bb.get("csp_e", 0.5),
            basic_mode=cfg.get("training_mode", "conv_silu"),
            backbone=bb["type"],
            neck=nk["type"],
            remat=bool(m.get("remat", False)),
            space_to_depth=bool(bb.get("space_to_depth", False)),
            dtype=dtype,
            head_type="fuseab" if fuse_ab else "distill_ns" if distill_ns else "effidehead",
            anchors_init=anchors,
            quantization_bins=6 if learned else None,
            sensor_hw=(data.get("height", 240), data.get("width", 304)),
            img_size=img_size or data.get("img_size", 640),
        )
    if generator is not None:
        init_weights_(model, generator)
    return model


def _default_anchors(strides):
    """Per-level (w, h) priors of the fuse-ab branch when the config gives
    none (the study's configs are anchor-free): three a level, at 2.5, 5 and
    8 times the stride, as the JAX package draws them; they shape only the
    train-time auxiliary branch."""
    return tuple((2.5 * s, 2.5 * s, 5.0 * s, 4.0 * s, 8.0 * s, 7.0 * s) for s in strides)
