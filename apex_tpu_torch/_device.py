"""Where the port's entry points run."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. Asking for CUDA without one raises; nothing falls back
    to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions "
            f"on the CPU")
    return device
