"""Utilities below every other layer of the package."""

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raises when CUDA was asked for and is absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device
