"""PyTorch/CUDA port of the Procgen fast path (maze first).

Module paths and function names mirror ``procgen_tpu`` so each function has
an obvious counterpart there.  Every function takes a leading env axis N
explicitly; state containers are dataclasses of tensors.  Entry points run
on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for but
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "procgen_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
