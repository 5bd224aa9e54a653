"""Device resolution for the port's entry points.

The port runs on the CUDA card unless the caller asks for the CPU: an entry
point given `device=None` takes `cuda`, and raises when there is no card
instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gcm_tpu_torch runs on the CUDA card by default and no card "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
