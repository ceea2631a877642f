"""Where the port's entry points put their tensors.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). With no device given and no CUDA card
present they raise: they never drop silently to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The caller's device, or ``cuda`` when none is given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda")
