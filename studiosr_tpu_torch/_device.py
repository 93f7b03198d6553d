"""Device resolution for the port's entry points.

Entry points (``SwinIR.build``, ``Model.inference``, ``swinir_fast_forward``
through the model) run on the card unless the caller passes ``device="cpu"``.
Asking for CUDA where there is none raises: the port never falls back to the
CPU.

Resolving a CUDA device also turns TF32 off for matmuls and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``). The port's float32 mode means float32
arithmetic, as the JAX package's default ``"highest"`` matmul precision does;
TF32 keeps about three decimal digits and would break the f32 tolerances the
kernels are held to.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on 'cuda' or 'cpu'")
    return dev
