"""The public model contract: numpy uint8 in, numpy uint8 out.

Port of ``studiosr_tpu/models/base.py``: ``inference`` takes an RGB uint8
HWC array and returns the upscaled RGB uint8 HWC array; ``forward_uint8``
does normalize -> forward -> x255, round, clip, uint8 on the device;
``inference_with_self_ensemble`` averages the 8 rot90 / flip variants;
``inference_tiled`` serves overlapping tiles (``parallel/tiled.py``);
``evaluate_uint8`` / ``evaluate_uint8_batch`` run the forward and the
PSNR / SSIM chain on the device and bring back two floats an image, never
the HR image; ``manual_forward_uint8`` / ``sharded_forward`` and the
``mesh=`` of ``evaluate_uint8_batch`` and ``inference_tiled`` split the
batch over the slots of a mesh (``parallel/mesh.py``: a replica a slot,
each running the single-card path on its share); ``astype(dtype)`` casts
the module and the forward's input (``half()`` is
``astype(torch.bfloat16)``, the serving dtype; it converts the module in
place, so a Trainer never calls it on the f32 weights it trains);
``eval()`` and ``to(device)`` chain as the reference's torch idiom
does; ``from_pretrained`` builds the family's published configuration (the
families with a release override it to read the weights, ``zoo/``);
``export`` saves the eval forward as a ``torch.export`` program and
``export_onnx`` as ONNX (where the ``onnx`` package is installed);
``get_model_config`` gives the reconstruction config (the Trainer's
``params.json``) and ``get_training_config`` the model's published training
recipe (``Trainer`` keyword arguments, ``_training_config``);
:class:`FusedServingModel` adds ``enable_fused`` and the cached load-time
``serving_prep``.

A model wraps an ``nn.Module`` that lives on ``self.device``. Forwards run
under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from studiosr_tpu_torch.utils.metrics import compute_psnr_torch, compute_ssim_torch

__all__ = ["Model", "FusedServingModel", "diverge_images", "converge_images"]


def diverge_images(image: np.ndarray) -> List[np.ndarray]:
    """The 8 rot90 x fliplr variants of an HWC image."""
    out = []
    for i in range(4):
        rotated = np.rot90(image, k=i, axes=(0, 1))
        flipped = np.fliplr(rotated)
        out.extend([rotated, flipped])
    return out


def converge_images(images: List[np.ndarray]) -> np.ndarray:
    """Invert :func:`diverge_images` on each output and average."""
    undone = []
    for i, image in enumerate(images):
        image = np.fliplr(image) if i & 1 else image
        image = np.rot90(image, k=i // 2, axes=(1, 0))
        undone.append(image)
    return np.mean(np.stack(undone), axis=0)


class Model:
    """Binds a PyTorch module (NHWC in, NHWC out), its config and its device."""

    _training_config: Dict[str, Any] = {}

    def __init__(self, module: nn.Module, config: Dict[str, Any], device: torch.device) -> None:
        self.module = module
        self.config = dict(config)
        self.device = torch.device(device)
        self._compute_dtype: Optional[torch.dtype] = None

    @property
    def scale(self) -> int:
        return int(self.config.get("scale", 4))

    @property
    def n_colors(self) -> int:
        return int(self.config.get("n_colors", 3))

    @property
    def img_range(self) -> float:
        return float(self.config.get("img_range", 1.0))

    @classmethod
    def from_pretrained(cls, scale: int = 4, device=None) -> "Model":
        """The family's published configuration; a family with released
        weights overrides this to read them (SRCNN, ESPCN and SRResNet have
        none and build, as in the JAX package)."""
        return cls.build(scale=scale, device=device)  # type: ignore[attr-defined]

    def get_model_config(self) -> Dict[str, Any]:
        return dict(self.config)

    def get_training_config(self) -> Dict[str, Any]:
        """The recipe the model is trained with, as ``Trainer`` arguments."""
        return dict(self._training_config)

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

    def manual_forward_uint8(self, x, mesh) -> torch.Tensor:
        """:meth:`forward_uint8` over ``mesh``: the batch cut into one equal
        contiguous share a slot, each slot's replica running the single-card
        path (fused kernels and tails included) on its share, the uint8
        results gathered on ``self.device`` in batch order, without
        synchronising. A batch that does not divide over the slots raises."""
        from studiosr_tpu_torch.parallel.mesh import run_sharded

        return run_sharded(self, mesh, lambda replica, share: replica.forward_uint8(share), torch.as_tensor(x))

    def sharded_forward(self, x, mesh=None) -> torch.Tensor:
        """The float NHWC forward (f32 out on ``self.device``); with ``mesh``,
        split over its slots as :meth:`manual_forward_uint8` splits the uint8
        one."""
        if mesh is None:
            return self(torch.as_tensor(x))
        from studiosr_tpu_torch.parallel.mesh import run_sharded

        return run_sharded(self, mesh, lambda replica, share: replica(share), torch.as_tensor(x))

    # -- numpy inference contract -------------------------------------------

    def inference(self, image: np.ndarray) -> np.ndarray:
        """uint8 HWC RGB -> upscaled uint8 HWC RGB."""
        batch = torch.from_numpy(np.ascontiguousarray(image))[None]
        return self.forward_uint8(batch)[0].cpu().numpy()

    def inference_batch(self, images) -> List[np.ndarray]:
        """:meth:`inference` over same-shaped images in one forward."""
        batch = torch.from_numpy(np.stack([np.asarray(im) for im in images]))
        return list(self.forward_uint8(batch).cpu().numpy())

    def inference_with_self_ensemble(self, image: np.ndarray) -> np.ndarray:
        """8-way test-time ensemble: the f32 outputs of the rot90 / flip
        variants, undone and averaged on the host, then rounded."""
        scale = 255.0 if self.img_range == 1.0 else 1.0
        outputs = []
        for variant in diverge_images(image.astype(np.float32) / scale):
            x = torch.from_numpy(np.ascontiguousarray(variant))[None]
            outputs.append(self(x)[0].cpu().numpy())
        merged = converge_images(outputs) * scale
        return np.clip(np.round(merged), 0, 255).astype(np.uint8)

    def inference_tiled(
        self, image: np.ndarray, tile: int = 128, tile_overlap: int = 16, tile_batch: int = 8, mesh=None,
        device_loop: Optional[bool] = None,
    ) -> np.ndarray:
        """Overlapping-tile inference (``parallel/tiled.py``), for large or
        variably sized inputs."""
        from studiosr_tpu_torch.parallel.tiled import tiled_inference

        return tiled_inference(self, image, tile=tile, tile_overlap=tile_overlap, tile_batch=tile_batch, mesh=mesh,
                               device_loop=device_loop)

    # -- on-device evaluation ------------------------------------------------

    @staticmethod
    def _metric_stack(sr: torch.Tensor, gt: torch.Tensor, crop_border: int, y_only: bool) -> torch.Tensor:
        """[PSNR, SSIM] of one uint8 SR / GT pair, on their device: the one
        metric chain both evaluation routes run."""
        return torch.stack([
            compute_psnr_torch(sr, gt, y_only=y_only, crop_border=crop_border),
            compute_ssim_torch(sr, gt, y_only=y_only, crop_border=crop_border),
        ])

    def evaluate_uint8(self, lq, gt, crop_border: int = 0, y_only: bool = True):
        """(PSNR, SSIM) of the model's output for uint8 ``lq`` against uint8
        ``gt``: the forward, the round / clip to uint8, the Y conversion and
        both metrics run on ``self.device``; two floats come back, the HR
        image never does. Matches the host numpy protocol to 1e-4 dB."""
        lq = torch.from_numpy(np.ascontiguousarray(lq))[None]
        with torch.inference_mode():
            sr = self.forward_uint8(lq)[0]
            gt = torch.from_numpy(np.ascontiguousarray(gt)).to(self.device)
            psnr, ssim = self._metric_stack(sr, gt, crop_border, y_only).tolist()
        return float(psnr), float(ssim)

    def evaluate_uint8_batch(self, lqs, gts, crop_border: int = 0, y_only: bool = True, mesh=None):
        """Per-image (PSNRs, SSIMs) numpy arrays of a same-shape uint8 batch,
        one forward on ``self.device``; a (B, 2) f32 array comes back. With
        a ``mesh`` (``parallel/mesh.py``) each slot scores its share of the
        images and only the (B, 2) array is gathered; B must divide by
        ``mesh.size``."""
        lqs = torch.from_numpy(np.ascontiguousarray(np.asarray(lqs)))
        gts = torch.from_numpy(np.ascontiguousarray(np.asarray(gts)))
        if mesh is None:
            with torch.inference_mode():
                out = self._score_batch(lqs, gts.to(self.device), crop_border, y_only).cpu().numpy()
            return out[:, 0], out[:, 1]
        if lqs.shape[0] % mesh.size:
            raise ValueError(f"evaluate_uint8_batch: batch {lqs.shape[0]} does not divide over the "
                             f"{mesh.size}-device mesh — pad or drop images")
        from studiosr_tpu_torch.parallel.mesh import run_sharded

        def score(replica, lq, gt):
            return replica._score_batch(lq, gt.to(replica.device), crop_border, y_only)

        out = run_sharded(self, mesh, score, lqs, gts).cpu().numpy()
        return out[:, 0], out[:, 1]

    def _score_batch(self, lqs, gts, crop_border: int, y_only: bool) -> torch.Tensor:
        srs = self.forward_uint8(lqs)
        return torch.stack([self._metric_stack(sr, gt, crop_border, y_only) for sr, gt in zip(srs, gts)])

    # -- dtype policy --------------------------------------------------------

    def astype(self, dtype: torch.dtype) -> "Model":
        """Cast the parameters to ``dtype``; inputs are cast to it in the forward."""
        self.module.to(dtype)
        self._compute_dtype = dtype
        self.__dict__.pop("_replica_cache", None)
        return self

    def half(self) -> "Model":
        """bfloat16 parameters and activations (the serving dtype)."""
        return self.astype(torch.bfloat16)

    # -- the reference's torch chainables ------------------------------------

    def eval(self) -> "Model":
        """The module in eval mode (the only mode forwards run in); chainable."""
        self.module.eval()
        return self

    def to(self, device) -> "Model":
        """Move the module to ``device`` (``resolve_device``'s rules: CUDA that
        is missing raises); drops the cached fused-serving weights and the
        mesh replicas."""
        from studiosr_tpu_torch._device import resolve_device

        self.device = resolve_device(device)
        self.module.to(self.device)
        self.__dict__.pop("_serving_prep_cache", None)
        self.__dict__.pop("_replica_cache", None)
        return self

    # -- export --------------------------------------------------------------

    def _export_input(self, input_shape) -> torch.Tensor:
        return torch.zeros(*input_shape, dtype=self._compute_dtype or torch.float32, device=self.device)

    def export(self, path: Optional[str] = None, input_shape: List[int] = [1, 256, 256, 3]) -> str:
        """Save the eval forward of the plain module (NHWC in, NHWC out, in the
        model's dtype) as a ``torch.export`` program (``torch.export.save``,
        reloaded with ``torch.export.load``), to ``{Class}x{scale}.pt2`` by
        default: the analog of the JAX package's StableHLO text. Returns the path."""
        if path is None:
            path = f"{self.__class__.__name__}x{self.scale}.pt2"
        with torch.no_grad():
            program = torch.export.export(self.module.eval(), (self._export_input(input_shape),))
        torch.export.save(program, path)
        return path

    def export_onnx(self, path: Optional[str] = None, input_shape: List[int] = [1, 64, 64, 3], opset: int = 17) -> str:
        """Save the eval forward of the plain module (NHWC) as ONNX to
        ``{Class}x{scale}.onnx`` by default. Needs the ``onnx`` package at
        call time and raises ``ImportError`` without it."""
        import onnx  # noqa: F401  (torch.onnx.export's TorchScript route writes through it)

        if path is None:
            path = f"{self.__class__.__name__}x{self.scale}.onnx"
        with torch.no_grad():
            torch.onnx.export(self.module.eval(), self._export_input(input_shape), path, opset_version=opset,
                              dynamo=False)
        return path


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
        """Serve through the CUDA kernels (serving/swinir_fast.py); drops the
        mesh replicas."""
        self._fused = enabled
        self.__dict__.pop("_replica_cache", None)
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
