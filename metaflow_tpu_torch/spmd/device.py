"""The device an entry point runs on, below the models and the mesh that
both take one."""

import torch


def resolve_device(device):
    """The torch.device an entry point runs on. A CUDA device without a
    card raises: the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device
