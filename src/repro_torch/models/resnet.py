"""ResNet-Tiny, the paper's client model (port of ``repro.models.resnet``).

Widths 64/128/256, depths 4/4/3, GroupNorm: 4,696,394 parameters for
32x32x3 inputs and 10 classes.  The parameters are a plain dict in the JAX
layout (HWIO conv weights) and the public functions take NHWC images, so a
ParamSpace row here is index-identical to the reference's.  The network runs
in NCHW inside: images are permuted once on entry and each weight is
permuted to OIHW at its conv call.

Three details of the reference are kept exactly:
  * XLA "SAME" padding: a stride-2 3x3 conv on an even size pads (0, 1),
    not (1, 1), so padding is computed per conv and applied with ``F.pad``;
  * GroupNorm with g = min(groups, C), biased variance and eps 1e-5;
  * the head is a mean over H and W, then ``x @ head_w + head_b``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet-tiny"
    widths: Sequence[int] = (64, 128, 256)
    depths: Sequence[int] = (4, 4, 3)
    in_channels: int = 3
    num_classes: int = 10
    groups: int = 8  # GroupNorm groups


def _conv_init(gen, k, cin, cout, device):
    fan_in = k * k * cin
    w = torch.randn((k, k, cin, cout), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * (2.0 / fan_in) ** 0.5).to(device)


def init_resnet(gen: torch.Generator, cfg: ResNetConfig, *, device) -> dict[str, torch.Tensor]:
    """Random parameters in the reference's layout, drawn from ``gen``."""
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    p = {"stem": _conv_init(gen, 3, cfg.in_channels, cfg.widths[0], device)}
    p["stem_s"], p["stem_b"] = ones(cfg.widths[0]), zeros(cfg.widths[0])
    cin = cfg.widths[0]
    for si, (w, d) in enumerate(zip(cfg.widths, cfg.depths)):
        for bi in range(d):
            pre = f"s{si}b{bi}"
            p[pre + "_c1"] = _conv_init(gen, 3, cin, w, device)
            p[pre + "_c2"] = _conv_init(gen, 3, w, w, device)
            p[pre + "_s1"], p[pre + "_b1"] = ones(w), zeros(w)
            p[pre + "_s2"], p[pre + "_b2"] = ones(w), zeros(w)
            if cin != w:
                p[pre + "_proj"] = _conv_init(gen, 1, cin, w, device)
            cin = w
    head = torch.randn((cin, cfg.num_classes), generator=gen, device=gen.device)
    p["head_w"] = (head * 0.01).to(device)
    p["head_b"] = zeros(cfg.num_classes)
    return p


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME": out = ceil(size / stride), the extra pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with an HWIO weight and XLA "SAME" padding."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    ph, pw = _same_pads(x.shape[2], kh, stride), _same_pads(x.shape[3], kw, stride)
    w = w_hwio.permute(3, 2, 0, 1)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def _gn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int) -> torch.Tensor:
    return F.group_norm(x, min(groups, x.shape[1]), scale, bias, eps=1e-5)


def resnet_forward(p: dict[str, torch.Tensor], cfg: ResNetConfig, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_gn(_conv(x, p["stem"]), p["stem_s"], p["stem_b"], cfg.groups))
    for si, (w, d) in enumerate(zip(cfg.widths, cfg.depths)):
        for bi in range(d):
            pre = f"s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            h = _conv(x, p[pre + "_c1"], stride)
            h = F.relu(_gn(h, p[pre + "_s1"], p[pre + "_b1"], cfg.groups))
            h = _gn(_conv(h, p[pre + "_c2"]), p[pre + "_s2"], p[pre + "_b2"], cfg.groups)
            sc = x
            if pre + "_proj" in p:
                sc = _conv(x, p[pre + "_proj"], stride)
            elif stride != 1:
                sc = x[:, :, ::stride, ::stride]
            x = F.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return x @ p["head_w"] + p["head_b"]


def resnet_loss(p: dict[str, torch.Tensor], cfg: ResNetConfig, batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean cross-entropy and accuracy of one batch {"image", "label"}."""
    logits = resnet_forward(p, cfg, batch["image"])
    labels = batch["label"].long()
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    loss = -logp.gather(1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"loss": loss, "acc": acc}
