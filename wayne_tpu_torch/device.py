"""Where the port's entry points run.

The entry points run on the CUDA card unless the caller passes
``device="cpu"``. Without a card they raise instead of falling back: a run
meant for the GPU must never quietly become a CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "wayne_tpu_torch runs on a CUDA device by default and none "
                "is present; pass device='cpu' (run_visit --cpu) to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
