"""Iteration-based trainer: train step, checkpoint/resume, periodic evaluation.

Port of ``studiosr_tpu/engine/trainer.py``, data-parallel over the
processes of a ``torch.distributed`` group when ``parallel/dist.py``'s
``initialize`` has started one (a card a process; NCCL on the card, gloo on
the CPU): every rank steps on its shard of the global batch with the
gradients averaged across ranks (``make_train_step(mesh=...)``), from rank
0's weights; rank 0 alone writes the log, evaluates and checkpoints, and a
resume reads the same checkpoint on every rank. Without a group, one
process on one device:

* the MultiStepLR Adam recipe (``parallel/train_step.py``), bf16 compute
  over f32 master weights on the card (f32 on the CPU), ``grad_accum_steps``
  and an EMA shadow (``ema_decay``);
* ``fused_train`` defaults on for a model on the card (and off on the CPU):
  every Swin block then runs forward and backward through the CUDA kernels
  B5-B8 (SwinIR), every HAB and OCAB through B5, B9, B6, B7, B12 and
  B13 (HAT), and every MaxSR attention pair through B5-B8. The module's
  flag is set for the steps and restored for the evaluations and after
  the run (the JAX Trainer fuses a clone for the step and evaluates the
  module it was given);
* each step draws its drop-path scales from a ``torch.Generator`` seeded
  from (seed, iteration), so a resumed run takes the same steps;
* checkpoints are the triple-file scheme ``{tag}.model.ckpt`` /
  ``{tag}.train.ckpt`` / ``{tag}.ema.ckpt`` + ``params.json``, written
  atomically (tmp + fsync + ``os.replace``) as ``torch.save`` state dicts;
  resume loads ``latest``, falls back to ``best`` only when the bytes are
  corrupt, and re-raises on config drift.

* ``evaluate`` scores on the card (``evaluator.run(model, on_device=True)``:
  the forward and the metrics on the device, two floats back an image) for
  a model on the card and the package's own evaluators, and on the host
  otherwise; ``eval_on_device`` forces either route, as the JAX Trainer's
  argument does.

* ``profile_dir`` traces the whole run with ``torch.profiler`` (host
  activity, and the card's kernels for a model on the card) and writes a
  Chrome trace into it when the run ends, as the JAX Trainer traces its
  run with ``jax.profiler``;
* ``debug_nans`` checks the loss and every gradient of each step before the
  update and raises ``FloatingPointError`` naming the iteration and the
  first non-finite one (the JAX Trainer sets ``jax_debug_nans``); it adds a
  device sync a step and leaves a finite step's state as it is without it;
* ``timings`` holds each step's host seconds in ``get_batch`` (the wait for
  the loader) and in the step call.

``steps_per_dispatch`` is accepted for the JAX package's signature and runs
the same step sequence one step at a time. Not ported yet: reading JAX
checkpoints.
"""

from __future__ import annotations

import io
import json
import os
import time
import warnings
from typing import Callable, List, Optional, Tuple

import torch

from studiosr_tpu_torch.data import DataHandler
from studiosr_tpu_torch.parallel.mesh import get_mesh, replicate
from studiosr_tpu_torch.parallel.train_step import TrainState, build_optimizer, make_train_step, prepare_state
from studiosr_tpu_torch.utils import Logger, get_loss

__all__ = ["Trainer", "step_generator"]


def step_generator(seed: int, iteration: int) -> torch.Generator:
    """The drop-path generator of one step: a function of (seed, iteration)."""
    return torch.Generator().manual_seed((int(seed) << 32) + int(iteration))


class Trainer:
    """Train a model wrapper on a paired dataset with periodic evaluation.

    ``loss_function`` takes a name ("l1", "mse", "charbonnier") or a
    ``(pred, target) -> scalar`` callable. ``evaluator`` is any object with
    ``run(inference_fn) -> (psnr, ssim)``; without one only ``latest`` is
    saved.
    """

    def __init__(
        self,
        model,
        train_dataset,
        evaluator=None,
        batch_size: int = 32,
        num_workers: int = 4,
        learning_rate: float = 0.0002,
        beta1: float = 0.9,
        beta2: float = 0.99,
        weight_decay: float = 0.0,
        max_iters: int = 500000,
        gamma: float = 0.5,
        milestones: List[int] = [250000, 400000, 450000, 475000],
        loss_function: Callable = "l1",
        eval_interval: int = 1000,
        ckpt_path: str = "checkpoints",
        bfloat16: bool = True,
        seed: int = 0,
        log_interval: int = 100,
        profile_dir: Optional[str] = None,
        debug_nans: bool = False,
        fused_train: Optional[bool] = None,
        ema_decay: float = 0.0,
        grad_accum_steps: int = 1,
        steps_per_dispatch: int = 1,
        eval_on_device: Optional[bool] = None,
    ) -> None:
        del steps_per_dispatch  # one step at a time: the same sequence of steps
        self.model = model
        self.dataset = train_dataset
        self.evaluator = evaluator
        self.eval_on_device = eval_on_device
        self.device = model.device

        self.batch_size = batch_size
        self.num_workers = num_workers
        self.max_iters = max_iters
        self.eval_interval = eval_interval
        self.ckpt_path = ckpt_path
        os.makedirs(self.ckpt_path, exist_ok=True)

        self.milestones = list(milestones)
        self.bfloat16 = bfloat16 and self.device.type == "cuda"
        self.seed = seed
        self.log_interval = log_interval
        self.profile_dir = profile_dir
        self.debug_nans = bool(debug_nans)
        self.timings: dict = {"get_batch": [], "step": []}

        # Fused-training kernels: opt in for modules that support the flag;
        # default on for those on the card.
        self.fused_train = False
        module = model.module
        supports_fused = hasattr(type(module), "fused_train")
        module_already_fused = supports_fused and module.fused_train
        if supports_fused and not module_already_fused:
            if fused_train is None:
                fused_train = self.device.type == "cuda" and not getattr(module, "drop_rate", 0.0)
            self.fused_train = bool(fused_train)
        elif fused_train is not None:
            if module_already_fused and fused_train is False:
                raise ValueError(
                    "fused_train=False cannot disable a module built with "
                    "fused_train=True; rebuild the module without the flag"
                )
            if not supports_fused and fused_train:
                warnings.warn(
                    f"fused_train=True ignored: {type(module).__name__} has no fused-training path", stacklevel=2
                )
        if self.fused_train:
            # a module that cannot take the route raises here (SwinIR or HAT with a drop_rate)
            module.fused_train = True
            module.fused_train = False

        self.criterion = get_loss(loss_function)
        self.ema_decay = float(ema_decay)
        self.best_psnr = 0.0
        self.tx = build_optimizer(
            learning_rate=learning_rate,
            beta1=beta1,
            beta2=beta2,
            weight_decay=weight_decay,
            milestones=self.milestones,
            gamma=gamma,
            accum_steps=int(grad_accum_steps),
        )
        self.state: Optional[TrainState] = None

    # -- main loop ----------------------------------------------------------

    def run(self) -> None:
        print(f"device: {self.device}  bf16: {self.bfloat16}  fused_train: {self.fused_train}")
        self.data_handler = DataHandler(
            self.dataset, self.batch_size, self.num_workers, seed=self.seed, normalize=False
        )
        self.data_handler.set_seed(self.seed)
        module = self.model.module
        mesh = get_mesh([self.device])
        replicate(module, mesh)  # every rank starts from rank 0's weights
        self.state = prepare_state(module, self.tx, ema_decay=self.ema_decay)
        if self.load("latest"):  # every rank reads the same checkpoint
            print(f"-> The latest checkpoint was loaded. [best_psnr = {self.best_psnr:6.3f}]")

        restore_fused = getattr(module, "fused_train", None)
        if self.fused_train:
            module.fused_train = True
        step_fn = make_train_step(module, self.tx, self.criterion, bfloat16=self.bfloat16, ema_decay=self.ema_decay,
                                  debug_nans=self.debug_nans, mesh=mesh)
        main = self.data_handler.is_main_process
        logger = Logger(os.path.join(self.ckpt_path, "train.log")) if main else None
        profiler = self._start_profiler()
        window_start, window_images = time.perf_counter(), 0
        try:
            while self.data_handler.iterations < self.max_iters:
                t0 = time.perf_counter()
                lq, gt = self.data_handler.get_batch()
                t1 = time.perf_counter()
                iterations = self.data_handler.iterations
                batch = (torch.from_numpy(lq), torch.from_numpy(gt))
                try:
                    self.state, loss = step_fn(self.state, *batch, step_generator(self.seed, iterations))
                except FloatingPointError as e:
                    raise FloatingPointError(f"iteration {iterations}: {e}") from e
                self.timings["get_batch"].append(t1 - t0)
                self.timings["step"].append(time.perf_counter() - t1)
                window_images += lq.shape[0]
                if iterations % self.log_interval == 0:
                    loss_value = float(loss)
                    elapsed = time.perf_counter() - window_start
                    rate = window_images / max(elapsed, 1e-9)
                    print(f" Iterations = {iterations:<8} loss = {loss_value:.5f} ({rate:7.1f} img/s)", end="\r")
                    window_start, window_images = time.perf_counter(), 0
                if iterations % self.eval_interval == 0 and main:
                    if self.fused_train:  # as the JAX Trainer, which fuses a clone for the step only
                        module.fused_train = restore_fused
                    try:
                        psnr, ssim = self.evaluate()
                    finally:
                        if self.fused_train:
                            module.fused_train = True
                    logger.info(f" Iterations = {iterations:<8}  PSNR: {psnr:6.3f} SSIM: {ssim:6.4f}")
                    if self.evaluator and self.best_psnr <= psnr:
                        self.best_psnr = psnr
                        self.save("best")
                    self.save("latest")
        finally:
            if restore_fused is not None:
                module.fused_train = restore_fused
            if logger:
                logger.close()
            self.data_handler.close()
            self._stop_profiler(profiler)

    def _start_profiler(self):
        """A running ``torch.profiler`` over the run when ``profile_dir`` is set."""
        if not self.profile_dir:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stop the profiler and write its Chrome trace into ``profile_dir``."""
        if profiler is None:
            return
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        name = f"trainer-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json"
        profiler.export_chrome_trace(os.path.join(self.profile_dir, name))

    def evaluate(self) -> Tuple[float, float]:
        if not self.evaluator:
            return 0.0, 0.0
        if self._eval_on_device():
            return self.evaluator.run(self.model, on_device=True)
        return self.evaluator.run(self.model.inference)

    def _eval_on_device(self) -> bool:
        """The card route: forced by ``eval_on_device``, else taken for a
        model on the card and one of the package's evaluators."""
        if self.eval_on_device is not None:
            return bool(self.eval_on_device)
        from studiosr_tpu_torch.engine.evaluator import _EvaluatorBase

        return self.device.type == "cuda" and isinstance(self.evaluator, _EvaluatorBase)

    # -- checkpointing ------------------------------------------------------

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        """Crash-safe write: tmp file in the same directory, fsync, ``os.replace``."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _bytes(obj) -> bytes:
        buffer = io.BytesIO()
        torch.save(obj, buffer)
        return buffer.getvalue()

    def _path(self, tag: str, kind: str) -> str:
        return os.path.join(self.ckpt_path, f"{tag}.{kind}.ckpt")

    def save(self, file_name: str) -> Tuple[str, str]:
        """Triple-file scheme: model weights, train state (+ EMA), params.json."""
        os.makedirs(self.ckpt_path, exist_ok=True)
        module = self.model.module
        model_path, train_path = self._path(file_name, "model"), self._path(file_name, "train")
        self._atomic_write(model_path, self._bytes({k: v.detach().cpu() for k, v in module.state_dict().items()}))
        opt = {
            k: ({n: t.detach().cpu() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in self.state.opt_state.items()
        }
        iteration = int(self.data_handler.iterations) if hasattr(self, "data_handler") else int(self.state.step)
        train = dict(opt_state=opt, iteration=iteration, step=int(self.state.step), best_psnr=float(self.best_psnr))
        self._atomic_write(train_path, self._bytes(train))
        if self.state.ema_params is not None:
            ema = {k: v.detach().cpu() for k, v in self.state.ema_params.items()}
            self._atomic_write(self._path(file_name, "ema"), self._bytes(ema))
        self._atomic_write(
            os.path.join(self.ckpt_path, "params.json"), json.dumps(self.model.get_model_config()).encode()
        )
        return model_path, train_path

    def load(self, file_name: str) -> bool:
        """Restore weights, optimizer state, iteration counter and best PSNR.

        A corrupt or truncated checkpoint falls back ``latest`` -> ``best``.
        A checkpoint whose bytes are intact but whose contents no longer
        match the model (config drift) is not corrupt: that re-raises."""
        try:
            return self._load_tag(file_name)
        except Exception as e:
            if self._ckpt_bytes_intact(file_name):
                raise
            warnings.warn(f"checkpoint '{file_name}' is corrupt ({e!r})")
            if file_name == "latest":
                try:
                    if self._load_tag("best"):
                        warnings.warn("resumed from 'best' instead")
                        return True
                except Exception as e2:
                    if self._ckpt_bytes_intact("best"):
                        raise
                    warnings.warn(f"checkpoint 'best' is corrupt too ({e2!r})")
            return False

    def _read(self, path: str):
        return torch.load(path, map_location="cpu", weights_only=True)

    def _ckpt_bytes_intact(self, file_name: str) -> bool:
        """True when every file ``_load_tag`` reads for ``file_name`` loads."""
        kinds = ["model", "train"] + (["ema"] if self.ema_decay else [])
        for kind in kinds:
            path = self._path(file_name, kind)
            if not os.path.isfile(path):
                continue
            try:
                self._read(path)
            except Exception:
                return False
        return True

    def _load_tag(self, file_name: str) -> bool:
        model_path, train_path = self._path(file_name, "model"), self._path(file_name, "train")
        if not (os.path.isfile(model_path) and os.path.isfile(train_path)):
            return False
        module = self.model.module
        if self.state is None:
            self.state = prepare_state(module, self.tx, ema_decay=self.ema_decay)
        weights = self._read(model_path)
        target = module.state_dict()
        if sorted(weights) != sorted(target):
            raise ValueError(f"checkpoint keys differ from the model's: model config drift? ({model_path})")
        for k, v in target.items():
            if tuple(weights[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"checkpoint shape mismatch at {k}: saved {tuple(weights[k].shape)} vs model {tuple(v.shape)}"
                    " -- model config drift?"
                )
        train = self._read(train_path)
        ema = None
        if self.ema_decay:
            ema_path = self._path(file_name, "ema")
            # a checkpoint from before EMA seeds the shadow from its weights
            ema = self._read(ema_path) if os.path.isfile(ema_path) else weights
        with torch.no_grad():
            for k, v in target.items():
                v.copy_(weights[k])
            for k, v in self.state.opt_state.items():
                if isinstance(v, dict):
                    for n, t in v.items():
                        t.copy_(train["opt_state"][k][n])
                else:
                    self.state.opt_state[k] = train["opt_state"][k]
            if ema is not None:
                for k, e in self.state.ema_params.items():
                    e.copy_(ema[k])
        self.state.step = int(train["step"])
        self.best_psnr = float(train["best_psnr"])
        if hasattr(self, "data_handler"):
            self.data_handler.set_iterations(int(train["iteration"]))
        return True
