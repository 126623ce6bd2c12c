"""PreActResNet18 with GroupNorm — the paper's experimental model (§3).

The port of ``repro.models.resnet``.  Complex model: 4 stages x 2
pre-activation basic blocks, channels (64, 128, 256, 512), GroupNorm in
place of BatchNorm.  Simple model: the stem and first 2 stages, then a
mix-pool exit head (learned convex combination of average and max pooling)
and a linear classifier.  The exit head lives inside the complex params,
and the index set M is ``stem + stage1 + stage2 + exit_head``.

Parameters keep the reference's tree and leaf shapes — conv kernels HWIO —
so flat layouts and weights carry across unchanged.  Each conv permutes its
kernel to OIHW at the call (a copy of that kernel per use: 45 MB for all
conv kernels of one full-width forward, small beside the activations).
Images arrive NHWC ``(B, H, W, 3)`` at :func:`forward`, as in the
reference; inside, activations are contiguous NCHW.
Every width is read from the params, so narrow trees run unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

STAGE_CHANNELS = (64, 128, 256, 512)
BLOCKS_PER_STAGE = 2
SIMPLE_STAGES = 2          # paper: first 2 residual stages


def _conv_init(generator, kh, kw, cin, cout) -> torch.Tensor:
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return torch.randn((kh, kw, cin, cout), generator=generator) * std


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (before, after) along one spatial dim: for a
    3x3 stride-2 conv on an even input it pads 0 before and 1 after, where
    ``padding=1`` would pad both sides and shift every output."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1
           ) -> torch.Tensor:
    """SAME conv of NCHW ``x`` with an HWIO kernel (the reference's
    ``conv_general_dilated(..., padding="SAME")``)."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    w = w_hwio.permute(3, 2, 0, 1)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


# ---------------------------------------------------------------------------
# Pre-activation basic block
# ---------------------------------------------------------------------------

def init_block(generator, cin, cout, stride) -> Params:
    p = {
        "gn1": common.init_groupnorm(cin),
        "conv1": _conv_init(generator, 3, 3, cin, cout),
        "gn2": common.init_groupnorm(cout),
        "conv2": _conv_init(generator, 3, 3, cout, cout),
    }
    if stride != 1 or cin != cout:
        p["shortcut"] = _conv_init(generator, 1, 1, cin, cout)
    return p


def apply_block(p: Params, x, stride):
    h = F.relu(common.apply_groupnorm(p["gn1"], x))
    shortcut = conv2d(h, p["shortcut"], stride) if "shortcut" in p else x
    h = conv2d(h, p["conv1"], stride)
    h = F.relu(common.apply_groupnorm(p["gn2"], h))
    h = conv2d(h, p["conv2"], 1)
    return h + shortcut


# ---------------------------------------------------------------------------
# Mix pooling head (Lee et al. 2016): alpha * avg + (1 - alpha) * max
# ---------------------------------------------------------------------------

def init_mixpool_head(generator, channels, n_classes) -> Params:
    return {
        "alpha": torch.zeros((), dtype=torch.float32),   # sigmoid(0) = 0.5
        "w": common.dense_init(generator, (channels, n_classes)),
        "b": torch.zeros((n_classes,), dtype=torch.float32),
    }


def apply_mixpool_head(p: Params, x) -> torch.Tensor:
    a = torch.sigmoid(p["alpha"])
    avg = x.mean(dim=(2, 3))
    mx = x.amax(dim=(2, 3))
    pooled = a * avg + (1.0 - a) * mx
    return pooled @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, n_classes: int = 10,
                channels: Sequence[int] = STAGE_CHANNELS) -> Params:
    """Random params on the CPU, drawn from ``generator`` (move them with
    ``tree_map``).  ``channels`` are the stage widths; the paper's model is
    the default, narrower ones serve the tests."""
    params: Params = {"stem": _conv_init(generator, 3, 3, 3, channels[0])}
    cin = channels[0]
    for s, cout in enumerate(channels):
        blocks = []
        for b in range(BLOCKS_PER_STAGE):
            stride = 2 if (s > 0 and b == 0) else 1
            blocks.append(init_block(generator, cin, cout, stride))
            cin = cout
        params[f"stage{s + 1}"] = blocks
    params["final_gn"] = common.init_groupnorm(channels[-1])
    params["head"] = {
        "w": common.dense_init(generator, (channels[-1], n_classes)),
        "b": torch.zeros((n_classes,), dtype=torch.float32),
    }
    params["exit_head"] = init_mixpool_head(
        generator, channels[SIMPLE_STAGES - 1], n_classes)
    return params


def _nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC images -> contiguous NCHW, the memory format every op below
    runs in (a permuted view would hand the convolutions channels-last
    strides)."""
    return images.permute(0, 3, 1, 2).contiguous()


def _run_stages(params: Params, x, n_stages: int):
    h = conv2d(x, params["stem"], 1)
    for s in range(n_stages):
        for b, blk in enumerate(params[f"stage{s + 1}"]):
            stride = 2 if (s > 0 and b == 0) else 1
            h = apply_block(blk, h, stride)
    return h


def forward(params: Params, images: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images: (B, H, W, 3) NHWC.  Returns (exit_logits, final_logits).

    One pass: the simple sub-network is a prefix, so the side objective's
    logits come from the stage-2 activation for free."""
    h = _run_stages(params, _nchw(images), SIMPLE_STAGES)
    exit_logits = apply_mixpool_head(params["exit_head"], h)
    for s in range(SIMPLE_STAGES, len(STAGE_CHANNELS)):
        for b, blk in enumerate(params[f"stage{s + 1}"]):
            h = apply_block(blk, h, 2 if b == 0 else 1)
    h = F.relu(common.apply_groupnorm(params["final_gn"], h))
    final_logits = h.mean(dim=(2, 3)) @ params["head"]["w"] \
        + params["head"]["b"]
    return exit_logits, final_logits


def forward_simple(params: Params, images: torch.Tensor) -> torch.Tensor:
    """Simple-architecture forward: stem, stages 1-2, exit head."""
    h = _run_stages(params, _nchw(images), SIMPLE_STAGES)
    return apply_mixpool_head(params["exit_head"], h)


def subnet_mask(params: Params) -> Params:
    """FedHeN index set M: stem + stage1 + stage2 + exit head are ``True``
    (every leaf), everything else ``False``."""
    keep = ("stem", "stage1", "stage2", "exit_head")
    return {name: tree_map(lambda _, k=name in keep: k, sub)
            for name, sub in params.items()}


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
