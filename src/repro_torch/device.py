"""Device policy of the port: entry points run on the card unless the caller
asks for the CPU; they never fall back to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none.  An
    explicit device (``"cpu"`` in the tests) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # the index a tensor allocated on "cuda" reports
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
