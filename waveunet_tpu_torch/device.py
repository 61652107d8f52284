"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(as the CPU tests do). Without a card they raise instead of quietly running on
the CPU: a separation that was meant for the card and ran on the host would
look like a working, very slow service. Several cards are several
processes, one a card (``parallel/``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "waveunet_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path on "
            "the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

