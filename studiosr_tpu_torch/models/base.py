"""The public model contract: numpy uint8 in, numpy uint8 out (subset).

Port of ``studiosr_tpu/models/base.py``: ``inference`` takes an RGB uint8
HWC array and returns the upscaled RGB uint8 HWC array; ``forward_uint8``
does normalize -> forward -> x255, round, clip, uint8 on the device;
``half()`` switches to bfloat16 serving; :class:`FusedServingModel` adds
``enable_fused`` and the cached load-time ``serving_prep``.

A model wraps an ``nn.Module`` that lives on ``self.device``. Forwards run
under ``torch.inference_mode``. Self-ensemble, on-device evaluation, tiled
serving and export are not part of this port yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

__all__ = ["Model", "FusedServingModel"]


class Model:
    """Binds a PyTorch module (NHWC in, NHWC out), its config and its device."""

    def __init__(self, module: nn.Module, config: Dict[str, Any], device: torch.device) -> None:
        self.module = module
        self.config = dict(config)
        self.device = torch.device(device)
        self._compute_dtype: Optional[torch.dtype] = None

    @property
    def img_range(self) -> float:
        return float(self.config.get("img_range", 1.0))

    def count_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # -- forward ------------------------------------------------------------

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward of an NHWC float batch on ``self.device``; f32 out."""
        if self._compute_dtype is not None:
            x = x.to(self._compute_dtype)
        return self.module(x).float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._forward(x.to(self.device))

    def forward_uint8(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC batch -> upscaled uint8 NHWC batch on ``self.device``.

        Returns without synchronising; the caller's copy to the host waits."""
        in_range = 255.0 if self.img_range == 1.0 else 1.0
        with torch.inference_mode():
            x = x.to(self.device).float() / in_range
            y = self._forward(x) * in_range
            return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)

    # -- numpy inference contract -------------------------------------------

    def inference(self, image: np.ndarray) -> np.ndarray:
        """uint8 HWC RGB -> upscaled uint8 HWC RGB."""
        batch = torch.from_numpy(np.ascontiguousarray(image))[None]
        return self.forward_uint8(batch)[0].cpu().numpy()

    def inference_batch(self, images) -> List[np.ndarray]:
        """:meth:`inference` over same-shaped images in one forward."""
        batch = torch.from_numpy(np.stack([np.asarray(im) for im in images]))
        return list(self.forward_uint8(batch).cpu().numpy())

    # -- dtype policy --------------------------------------------------------

    def half(self) -> "Model":
        """bfloat16 parameters and activations (the serving dtype)."""
        self.module.to(torch.bfloat16)
        self._compute_dtype = torch.bfloat16
        return self


class FusedServingModel(Model):
    """Models with a fused CUDA serving path: ``enable_fused`` switching and
    the cached load-time ``serving_prep``. Subclasses implement
    :meth:`_fused_fns`."""

    _fused = False

    def _fused_fns(self):
        """Return ``(fast_forward, prepare)``: ``fast_forward(module, x,
        config, prep=None)`` and ``prepare(module, config, dtype)``."""
        raise NotImplementedError

    def enable_fused(self, enabled: bool = True) -> "FusedServingModel":
        """Serve through the CUDA kernels (serving/swinir_fast.py)."""
        self._fused = enabled
        return self

    def serving_prep(self):
        """Kernel-layout weights for the fused path, built once per
        (dtype, parameter storage and version): ``half()`` and in-place
        weight loads (``zoo.translate.load_jax_params``) both invalidate it."""
        if not self._fused:
            return None
        dtype = self._compute_dtype or torch.float32
        key = (dtype, tuple((p.data_ptr(), p._version) for p in self.module.parameters()))
        cache = getattr(self, "_serving_prep_cache", None)
        if cache is not None and cache[0] == key:
            return cache[1]
        with torch.inference_mode():
            prep = self._fused_fns()[1](self.module, self.config, dtype)
        self._serving_prep_cache = (key, prep)
        return prep

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._fused:
            return super()._forward(x)
        fast_forward = self._fused_fns()[0]
        if self._compute_dtype is not None:
            x = x.to(self._compute_dtype)
        return fast_forward(self.module, x, self.config, prep=self.serving_prep()).float()
