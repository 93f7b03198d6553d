"""EDSR — Enhanced Deep Residual Networks (NHWC, PyTorch).

Port of ``studiosr_tpu/models/edsr.py``: mean shift, a head conv,
``n_resblocks`` ResBlocks (residual scale ``res_scale``) and a conv joined
to the head, a PixelShuffle tail, mean shift back. The convs run on cuDNN,
as the JAX package leaves them to XLA. Module names are the flax paths
(``head.0``, ``body.i.body.{0,2}``, ``body.{n}``, ``tail.0.{0,2}``,
``tail.1``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from studiosr_tpu_torch._device import resolve_device
from studiosr_tpu_torch.models.base import Model
from studiosr_tpu_torch.models.blocks import ResBlock, Upsampler, conv, flax_default_init, mean_shift, slots

__all__ = ["EDSR", "EDSRModule"]

_TRAINING_CONFIG: Dict[str, Any] = dict(
    batch_size=16, learning_rate=0.0001, beta1=0.9, beta2=0.99, weight_decay=0.0, max_iters=1000000, gamma=0.5,
    milestones=[200000, 400000, 600000, 800000],
)


class EDSRModule(nn.Module):
    def __init__(self, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 256,
                 n_resblocks: int = 32, res_scale: float = 0.1) -> None:
        super().__init__()
        self.img_range = img_range
        self.head = slots({"0": conv(n_colors, n_feats)})
        body = {str(i): ResBlock(n_feats, 3, res_scale) for i in range(n_resblocks)}
        body[str(n_resblocks)] = conv(n_feats, n_feats)
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


class EDSR(Model):
    _training_config = _TRAINING_CONFIG

    @classmethod
    def build(cls, scale: int = 4, n_colors: int = 3, img_range: float = 1.0, n_feats: int = 256,
              n_resblocks: int = 32, res_scale: float = 0.1, seed: int = 0, device=None) -> "EDSR":
        """Seeded EDSR on ``device`` (default ``cuda``), in eval mode."""
        dev = resolve_device(device)
        config = dict(scale=scale, n_colors=n_colors, img_range=img_range, n_feats=n_feats, n_resblocks=n_resblocks,
                      res_scale=res_scale)
        module = EDSRModule(**config)
        flax_default_init(module, torch.Generator().manual_seed(seed))
        return cls(module.to(dev).eval(), config, dev)

    @classmethod
    def from_pretrained(cls, scale: int = 4, dataset: str = "DIV2K", device=None) -> "EDSR":
        """The published EDSR weights from ``./pretrained`` (downloaded there on
        first use): the authors' DIV2K models (pixel range 255) or the DF2K
        ones (range 1), every parameter required."""
        from studiosr_tpu_torch.zoo import fetch, load_torch_state_dict, translate_state_dict

        if scale not in (2, 3, 4) or dataset not in ("DIV2K", "DF2K"):
            raise ValueError(f"EDSR.from_pretrained: no release at scale {scale}, dataset {dataset}")
        if dataset == "DIV2K":
            urls = {
                2: "https://cv.snu.ac.kr/research/EDSR/models/edsr_x2-0edfb8a3.pt",
                3: "https://cv.snu.ac.kr/research/EDSR/models/edsr_x3-ea3ef2c6.pt",
                4: "https://cv.snu.ac.kr/research/EDSR/models/edsr_x4-4f62e9ef.pt",
            }
            model = cls.build(scale=scale, img_range=255.0, device=device)
            path = fetch(f"r32f256x{scale}.pth", url=urls[scale])
        else:
            file_ids = {
                2: "1XEqY_nkUMdIid4lM9zAW99rYDx5eftBT",
                3: "1H1yFCFK14Z0DWAZHCtGXcWS6377fbkJE",
                4: "1TeH67rKNSR3dXs56aLqsA-UvLL3TZL-g",
            }
            model = cls.build(scale=scale, device=device)
            path = fetch(f"EDSRx{scale}.pth", gdrive_id=file_ids[scale])
        translate_state_dict(load_torch_state_dict(path), model.module)
        return model
