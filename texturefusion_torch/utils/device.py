"""The device of a run, checked: the entry points run on the card unless
the caller names another device."""

import torch


def resolve_device(name) -> torch.device:
    """torch.device(name); a CUDA device on a machine without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available on this machine "
                           f"(pass --device cpu to run on the CPU)")
    return device
