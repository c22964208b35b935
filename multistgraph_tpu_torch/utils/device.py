"""Device selection for the port's entry points.

Every entry point runs on CUDA unless the caller names the CPU: a missing
card is an error, never a silent fall back to the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; ``"cpu"`` must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device {!r} asked for, but CUDA is not available".format(device))
    return dev
