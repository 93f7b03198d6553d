"""One optimizer step: forward, loss, backward, Adam, EMA, data-parallel
over the processes of a mesh.

Port of ``studiosr_tpu/parallel/train_step.py``:

* ``TrainState``: the f32 master parameters, the optimizer state, the step
  count and the optional EMA shadow. Its ``params`` are the module's own
  ``nn.Parameter`` objects, updated in place (the JAX state is rebuilt each
  step; in place saves a copy of every parameter and keeps the module in
  step with the state without a sync);
* ``build_optimizer``: Adam with torch-style L2 (weight decay added to the
  gradient before the moments), a multistep schedule, and ``accum_steps``
  (the mean of k micro-step gradients, one update every k), with optax's
  arithmetic (``scale_by_adam``, ``piecewise_constant_schedule``,
  ``MultiSteps``); milestones count optimizer updates;
* ``make_train_step`` with the bf16 policy: the forward runs on bf16 copies
  of the f32 parameters and a bf16 input through a functional call (not
  autocast, which rounds at other places), the loss is f32, gradients flow
  back through the cast and arrive in f32. uint8 batches are divided by
  255 on the device. The EMA decays only on steps that applied an update.
  ``debug_nans`` checks the loss and every gradient before the update and
  raises ``FloatingPointError`` naming the first non-finite one (the
  counterpart of ``jax_debug_nans``); a finite step is not changed by it.
* ``mesh=`` (``parallel/mesh.py``) with a process group: each process
  steps on its own shard of the batch, and the loss and the gradients are
  all-reduced to their mean over the processes, as one flat bucket, before
  Adam (the JAX step's ``pmean`` under ``shard_map``), so every rank applies
  the same update. Each rank's drop-path / dropout generator is folded with
  its rank, so the shards draw different masks; BatchNorm normalises over
  the local shard and its running statistics are averaged across ranks
  after the step (DDP without SyncBN, the JAX manual path's semantics).
  Without a group the step is the mesh-less one; in a group of one
  process it runs the collectives, which are the identity there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call

from studiosr_tpu_torch.parallel.mesh import Mesh, all_reduce_mean

__all__ = [
    "TrainState", "Adam", "multistep_schedule", "build_optimizer", "make_train_step", "prepare_state",
]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def multistep_schedule(learning_rate: float, milestones: Sequence[int], gamma: float) -> Callable[[int], float]:
    """lr * gamma^(number of milestones m with count >= m)."""
    marks = sorted(int(m) for m in milestones)

    def schedule(count: int) -> float:
        lr = learning_rate
        for m in marks:
            if count >= m:
                lr *= gamma
        return lr

    return schedule


class Adam:
    """Adam (eps 1e-8) with torch-style L2, a schedule and gradient
    accumulation. ``init`` builds the state; ``update`` changes the
    parameters in place and says whether it applied an update. Every
    update runs over all tensors at once (``torch._foreach_*``): a few
    launches a step instead of several per parameter tensor."""

    def __init__(
        self,
        learning_rate: float = 2e-4,
        beta1: float = 0.9,
        beta2: float = 0.99,
        weight_decay: float = 0.0,
        milestones: Sequence[int] = (),
        gamma: float = 0.5,
        accum_steps: int = 1,
        eps: float = 1e-8,
    ) -> None:
        self.schedule = multistep_schedule(learning_rate, milestones, gamma)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay
        self.accum_steps = max(1, int(accum_steps))

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}  # noqa: E731
        state = {"count": 0, "mini_step": 0, "mu": zeros(), "nu": zeros()}
        if self.accum_steps > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict[str, Any]) -> bool:
        keys = list(params)
        g = [grads[k] for k in keys]
        acc = None
        if self.accum_steps > 1:
            n = state["mini_step"]
            acc = [state["acc"][k] for k in keys]
            torch._foreach_add_(acc, torch._foreach_sub(g, acc), alpha=1.0 / (n + 1))  # MultiSteps' running mean
            state["mini_step"] = (n + 1) % self.accum_steps
            if state["mini_step"]:
                return False
            g = acc
        p = [params[k] for k in keys]
        if self.weight_decay:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        count = state["count"]
        lr = self.schedule(count)
        b1, b2 = self.beta1, self.beta2
        mu, nu = [state["mu"][k] for k in keys], [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        denom = torch._foreach_div(nu, 1.0 - b2 ** (count + 1))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, 1.0 - b1 ** (count + 1))
        torch._foreach_div_(step, denom)
        torch._foreach_add_(p, step, alpha=-lr)
        if acc is not None:
            torch._foreach_zero_(acc)
        state["count"] = count + 1
        return True


def build_optimizer(
    learning_rate: float = 2e-4,
    beta1: float = 0.9,
    beta2: float = 0.99,
    weight_decay: float = 0.0,
    milestones: Sequence[int] = (),
    gamma: float = 0.5,
    accum_steps: int = 1,
) -> Adam:
    return Adam(learning_rate, beta1, beta2, weight_decay, milestones, gamma, accum_steps)


def prepare_state(module: nn.Module, tx: Adam, ema_decay: float = 0.0) -> TrainState:
    """State over ``module``'s parameters, which must be f32 (master
    weights); ``ema_decay > 0`` seeds the EMA shadow from them."""
    params = dict(module.named_parameters())
    wrong = [k for k, p in params.items() if p.dtype != torch.float32]
    if wrong:
        raise TypeError(f"training needs f32 master parameters; {wrong[:3]} are not (was the model half()-ed?)")
    ema = {k: p.detach().clone() for k, p in params.items()} if ema_decay else None
    return TrainState(params=params, opt_state=tx.init(params), step=0, ema_params=ema)


def _to_unit(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    t = t.to(device, non_blocking=True)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()


def check_finite(loss: torch.Tensor, names: Sequence[str], grads: Sequence[torch.Tensor]) -> None:
    """Raise ``FloatingPointError`` unless the loss and every gradient are
    finite, naming the first parameter whose gradient is not."""
    finite = torch.stack([torch.isfinite(loss).all()] + [torch.isfinite(g).all() for g in grads]).cpu()
    if bool(finite.all()):
        return
    if not bool(finite[0]):
        raise FloatingPointError(f"non-finite loss {float(loss.detach())}")
    first = int((~finite[1:]).nonzero()[0])
    raise FloatingPointError(f"non-finite gradient of {names[first]}")


def fold_generator(generator: Optional[torch.Generator], rank: int) -> Optional[torch.Generator]:
    """A generator of its own for rank ``rank`` from the step's
    (``jax.random.fold_in`` of the step key with the device index)."""
    if generator is None:
        return None
    return torch.Generator().manual_seed((generator.initial_seed() * 1_000_003 + rank + 1) % (1 << 63))


def make_train_step(
    module: nn.Module, tx: Adam, loss_fn: Callable, bfloat16: bool = True, ema_decay: float = 0.0,
    debug_nans: bool = False, mesh: Optional[Mesh] = None,
):
    """``step(state, lq, gt, generator=None) -> (state, loss)``: one
    optimizer step on ``module`` (trained in training mode, left in the mode
    it was in). ``generator`` feeds the drop-path and dropout draws;
    ``debug_nans`` raises before the update on a non-finite loss or
    gradient. With a ``mesh`` of several processes, ``lq`` and ``gt`` are
    this rank's shard and the returned loss is the mean over the ranks."""
    device = next(module.parameters()).device
    parallel = mesh is not None and torch.distributed.is_initialized()
    stats = [b for k, b in module.named_buffers() if k.endswith(("running_mean", "running_var"))] if parallel else []

    def step(state: TrainState, lq: torch.Tensor, gt: torch.Tensor, generator: Optional[torch.Generator] = None):
        x, target = _to_unit(lq, device), _to_unit(gt, device)
        names = list(state.params)
        masters = [state.params[k] for k in names]
        if parallel and mesh.world_size > 1:
            generator = fold_generator(generator, mesh.rank)
        was_training = module.training
        module.train()
        try:
            with torch.enable_grad():
                compute = masters
                if bfloat16:
                    compute = [p.to(torch.bfloat16) for p in masters]
                    x = x.to(torch.bfloat16)
                out = functional_call(module, dict(zip(names, compute)), (x,), {"generator": generator})
                loss = loss_fn(out.float(), target)
                grads = torch.autograd.grad(loss, masters)
        finally:
            module.train(was_training)
        loss = loss.detach()
        if parallel:
            loss, *grads = all_reduce_mean([loss, *grads], mesh)
            if stats:
                with torch.no_grad():
                    for b, mean in zip(stats, all_reduce_mean(stats, mesh)):
                        b.copy_(mean)
        if debug_nans:
            check_finite(loss, names, grads)
        applied = tx.update(state.params, dict(zip(names, grads)), state.opt_state)
        if ema_decay and applied:
            with torch.no_grad():
                ema = list(state.ema_params.values())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [state.params[k] for k in state.ema_params], alpha=1.0 - ema_decay)
        state.step += 1
        return state, loss

    return step
