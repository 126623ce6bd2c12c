"""The port's device rule.

Entry points run on ``cuda`` unless the caller asks for the CPU by
passing ``device="cpu"``.  Without a CUDA device and without that request
they raise: a run that silently carried on on the CPU would report CPU
numbers under the card's name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``"cuda"``.  A CUDA device requires
    ``torch.cuda.is_available()``; there is no fallback.  On CUDA it turns
    TF32 off for matmuls and cuDNN convolutions: the reference computes in
    float32, and cuDNN convolutions default to TF32 (about three decimal
    digits), which no parity tolerance of the port allows for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

