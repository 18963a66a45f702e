"""Device resolution: the port's entry points run on the card unless the
caller asks for the CPU, and never fall back to it silently."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and is
    not available (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev
