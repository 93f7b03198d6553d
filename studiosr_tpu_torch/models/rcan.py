"""RCAN — residual-in-residual channel-attention network (NHWC, PyTorch).

Port of ``studiosr_tpu/models/rcan.py``: mean shift, a head conv,
``n_resgroups`` ResidualGroups of ``n_resblocks`` RCABs (conv-ReLU-conv and
a squeeze-excite channel gate, an identity residual) and a conv, each group
in a residual, a conv joined to the head, a PixelShuffle tail, mean shift
back. The convs run on cuDNN. Module names are the flax paths
(``body.g.body.i.body.{0,2,3}``, ``body.g.body.{n}``, ``tail.0``,
``tail.1``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import ChannelAttention, Upsampler, conv, flax_default_init, mean_shift, slots

__all__ = ["RCAN", "RCANModule", "RCAB", "ResidualGroup"]

_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=16, learning_rate=0.0001, beta1=0.9, beta2=0.99, weight_decay=0.0, max_iters=1000000, gamma=0.5,
    milestones=[200000, 400000, 600000, 800000],
)


class RCAB(nn.Module):
    """conv-ReLU-conv + channel attention, with the identity residual."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 16) -> None:
        super().__init__()
        self.body = slots({"0": conv(n_feat, n_feat, kernel_size), "2": conv(n_feat, n_feat, kernel_size),
                           "3": ChannelAttention(n_feat, reduction)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.body._modules
        return x + b["3"](b["2"](F.relu(b["0"](x))))


class ResidualGroup(nn.Module):
    """``n_resblocks`` RCABs and a conv, in a residual."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 16, n_resblocks: int = 20) -> None:
        super().__init__()
        body = {str(i): RCAB(n_feat, kernel_size, reduction) for i in range(n_resblocks)}
        body[str(n_resblocks)] = conv(n_feat, n_feat, kernel_size)
        self.body = slots(body)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for block in self.body.children():
            res = block(res)
        return x + res


class RCANModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 64,
                 n_resblocks: int = 20, n_resgroups: int = 10, reduction: int = 16) -> None:
        super().__init__()
        self.img_range = img_range
        self.head = slots({"0": conv(n_colors, n_feats)})
        body = {str(g): ResidualGroup(n_feats, 3, reduction, n_resblocks) for g in range(n_resgroups)}
        body[str(n_resgroups)] = conv(n_feats, n_feats)
        self.body = slots(body)
        self.tail = slots({"0": Upsampler(scale, n_feats), "1": conv(n_feats, n_colors)})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """NHWC forward; ``generator`` (the Trainer's draws) is unused: no layer is stochastic."""
        x = self.head._modules["0"](mean_shift(x, self.img_range, sign=-1))
        res = x
        for block in self.body.children():
            res = block(res)
        tail = self.tail._modules
        return mean_shift(tail["1"](tail["0"](res + x)), self.img_range, sign=1)


class RCAN(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 64,
              n_resblocks: int = 20, n_resgroups: int = 10, reduction: int = 16, seed: int = 0,
              device=None) -> "RCAN":
        """Seeded RCAN on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, n_feats=n_feats, n_resblocks=n_resblocks,
                      n_resgroups=n_resgroups, reduction=reduction)
        module = RCANModule(**config)
        flax_default_init(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)

    @classmethod
    def from_pretrained(cls, scale: int = 4, device=None) -> "RCAN":
        """The published ``RCAN_BIX{scale}`` weights (pixel range 255) from
        ``./pretrained/models_ECCV2018RCAN``; the authors' zip is downloaded
        and extracted there only when that directory is absent. Missing
        parameters keep their initial values, as the reference's
        ``strict=False`` load."""
        from studiosr_tpu_torch.utils.helpers import gdown_and_extract
        from studiosr_tpu_torch.zoo import load_torch_state_dict, translate_state_dict

        pretrained_dir = "pretrained"
        rcan_path = os.path.join(pretrained_dir, "models_ECCV2018RCAN")
        if not os.path.exists(rcan_path):
            os.makedirs(pretrained_dir, exist_ok=True)
            gdown_and_extract(id="10bEK-NxVtOS9-XSeyOZyaRmxUTX3iIRa", save_dir=pretrained_dir)
        model = cls.build(scale=scale, img_range=255.0, device=device)
        state = load_torch_state_dict(os.path.join(rcan_path, f"RCAN_BIX{scale}.pt"))
        translate_state_dict(state, model.module, strict=False)
        return model
