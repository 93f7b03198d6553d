"""Training losses as plain PyTorch functions.

Port of ``studiosr_tpu/utils/losses.py``: ``(pred, target) -> scalar``
functions, L1 the default, plus L2 (alias mse) and Charbonnier.
"""

from __future__ import annotations

import torch

__all__ = ["l1_loss", "l2_loss", "charbonnier_loss", "CharbonnierLoss", "get_loss"]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """sqrt((x - y)^2 + eps), mean-reduced."""
    return torch.mean(torch.sqrt(torch.square(pred - target) + eps))


class CharbonnierLoss:
    """Callable wrapper mirroring the reference class interface."""

    def __init__(self, eps: float = 1e-6, reduction: str = "mean") -> None:
        self.eps = eps
        self.reduce = torch.mean if reduction == "mean" else torch.sum

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.reduce(torch.sqrt(torch.square(x - y) + self.eps))


_LOSSES = {
    "l1": l1_loss,
    "l2": l2_loss,
    "mse": l2_loss,
    "charbonnier": charbonnier_loss,
}


def get_loss(name_or_fn):
    """Resolve a loss by name or pass a callable through."""
    if callable(name_or_fn):
        return name_or_fn
    return _LOSSES[str(name_or_fn).lower()]
