"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: asking for
``"cuda"`` on a machine without one raises instead of moving to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Keep float32 convs and matmuls in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits), and the log-VQT's log epilogue and the encoder parity both need
    full float32. This sets a process-wide PyTorch flag.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
