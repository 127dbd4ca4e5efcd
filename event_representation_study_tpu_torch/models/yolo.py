"""Detector assembly (the JAX package's ``models/yolo.py``).

``build_model(cfg, num_classes, ...)`` resolves backbone/neck/head by
registry name and returns a :class:`Detector` whose ``forward`` runs
[backbone -> neck -> head] on NCHW input; train mode returns (featmaps,
cls_scores, reg_distri), eval mode the decoded (B, A, 5+nc).

Only the paper graph is ported: ``SwinTransformerV2``/``CSPBackboneP6`` +
``CSPRepBiFPANNeck_P6`` + ``EffiDeHead``. The rest of the zoo is ROADMAP
item M14.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .. import resolve_device
from .backbones import CSPBackboneP6
from .heads import EffiDeHead
from .necks import CSPRepBiFPANNeck_P6

BACKBONES = {
    "SwinTransformerV2": CSPBackboneP6,  # the reference's name for it
    "CSPBackboneP6": CSPBackboneP6,
}
NECKS = {"CSPRepBiFPANNeck_P6": CSPRepBiFPANNeck_P6}
HEADS = {"EffiDeHead": EffiDeHead}


def _scale(v, multiple, divisor: int = 8):
    return math.ceil(v * multiple / divisor) * divisor


class Detector(nn.Module):
    """backbone + neck + head, names ``backbone``/``neck``/``head`` as in the
    Flax tree."""

    def __init__(self, in_channels: int, channels_list: Sequence[int],
                 num_repeats: Sequence[int], num_classes: int,
                 head_in_channels: Sequence[int], strides=(8, 16, 32, 64),
                 reg_max: int = 16, csp_e: float = 0.5, basic_mode: str = "conv_silu"):
        super().__init__()
        self.backbone = CSPBackboneP6(in_channels, channels_list[:6],
                                      num_repeats[:6], basic_mode, csp_e)
        self.neck = CSPRepBiFPANNeck_P6(channels_list, num_repeats, basic_mode, csp_e)
        self.head = EffiDeHead(num_classes, head_in_channels, self.neck.out_channels,
                               strides, reg_max)

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation from ``generator``: every conv and
    transpose-conv kernel lecun-normal (truncated normal, std
    sqrt(1/fan_in)/0.8796), biases 0, BatchNorm scale 1 / bias 0 / mean 0 /
    var 1, residual scales 1, then the head's pred-conv constants."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if isinstance(mod, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
        for name, p in model.named_parameters():
            if name.endswith("alpha"):
                p.fill_(1.0)
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
) -> Detector:
    """Build from an experiment-config dict (``cfg['model']`` with
    backbone/neck/head sub-dicts), on ``device`` (``cuda`` unless the caller
    asks for ``cpu``), initialised from ``generator`` when one is given."""
    m = cfg["model"]
    depth_mul = m.get("depth_multiple", 1.0)
    width_mul = m.get("width_multiple", 1.0)
    bb, nk, hd = m["backbone"], m["neck"], m["head"]
    for kind, name, registry in (("backbone", bb["type"], BACKBONES),
                                 ("neck", nk["type"], NECKS),
                                 ("head", hd.get("type", "EffiDeHead"), HEADS)):
        if name not in registry:
            raise NotImplementedError(
                f"{kind} {name!r} is not ported (ROADMAP M14); ported: {sorted(registry)}"
            )
    if not hd.get("use_dfl", True):
        raise NotImplementedError("the head without DFL is not ported (ROADMAP M14)")
    channels = [
        _scale(c, width_mul) for c in list(bb["out_channels"]) + list(nk["out_channels"])
    ]
    repeats = [
        (max(round(r * depth_mul), 1) if r > 1 else r)
        for r in list(bb["num_repeats"]) + list(nk["num_repeats"])
    ]
    head_in = [_scale(c, width_mul) for c in hd["in_channels"]]
    with torch.device(resolve_device(device)):
        model = Detector(
            in_channels=num_channels,
            channels_list=channels,
            num_repeats=repeats,
            num_classes=num_classes,
            head_in_channels=head_in,
            strides=tuple(hd.get("strides", (8, 16, 32, 64))),
            reg_max=hd.get("reg_max", 16),
            csp_e=bb.get("csp_e", 0.5),
            basic_mode=cfg.get("training_mode", "conv_silu"),
        )
    if generator is not None:
        init_weights_(model, generator)
    return model
