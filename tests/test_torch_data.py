"""The port's data pipeline, losses and Trainer vs the JAX package, on the CPU.

The loader is plain Python and numpy in both packages, so the port's
batches must be bitwise those of the JAX package's for the same seed and
dataset. The Trainer tests save, resume and fall back on a tiny SwinIR.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from studiosr_tpu.data.dataset import PairedImageDataset as JaxPairedImageDataset
from studiosr_tpu.data.handler import PrefetchLoader as JaxPrefetchLoader
from studiosr_tpu.utils import losses as jax_losses
from studiosr_tpu_torch import SwinIR, Trainer
from studiosr_tpu_torch.data import DataHandler, PairedImageDataset, PrefetchLoader
from studiosr_tpu_torch.utils import losses

torch.set_num_threads(2)

TINY = dict(scale=2, embed_dim=8, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0,
            upsampler="pixelshuffledirect", drop_path_rate=0.1)


def _pairs(n=7, lr=20, scale=2, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, 256, (lr, lr, 3), dtype=np.uint8), rng.integers(0, 256, (lr * scale, lr * scale, 3), np.uint8))
        for _ in range(n)
    ]


def _in_memory(base):
    class InMemory(base):
        """Pairs held in memory; the standard crop/flip/rot90 pipeline."""

        def __init__(self, pairs, size, scale, to_tensor=False):
            self.pairs = pairs
            self.files = [str(i) for i in range(len(pairs))]
            self._init_pipeline(size, scale, True, to_tensor)

        def get_image_pair(self, idx):
            return self.pairs[idx]

    return InMemory


@pytest.mark.parametrize("normalize", [False, True])
def test_prefetch_loader_batches_match_jax_bitwise(normalize):
    """Three batches of 3 from 7 pairs cross an epoch boundary (the epoch
    holds 2 batches); crops, flips and rot90s draw from the same per-sample
    ``random.Random`` in both packages."""
    pairs = _pairs()
    ours = PrefetchLoader(_in_memory(PairedImageDataset)(pairs, 8, 2), 3, num_workers=2, seed=5, normalize=normalize)
    ref = JaxPrefetchLoader(_in_memory(JaxPairedImageDataset)(pairs, 8, 2), 3, num_workers=2, seed=5,
                            normalize=normalize)
    for start in (0, 3):
        got, want = ours.batches(start), ref.batches(start)
        for _ in range(3):
            (lq, gt), (jlq, jgt) = next(got), next(want)
            assert lq.dtype == jlq.dtype == (np.float32 if normalize else np.uint8)
            assert lq.shape == (3, 8, 8, 3) and gt.shape == (3, 16, 16, 3)
            np.testing.assert_array_equal(lq, jlq)
            np.testing.assert_array_equal(gt, jgt)
        got.close()
        want.close()


def test_dataset_to_tensor_matches_jax():
    pairs = _pairs(n=2)
    ours = _in_memory(PairedImageDataset)(pairs, 8, 2, to_tensor=True)
    ref = _in_memory(JaxPairedImageDataset)(pairs, 8, 2, to_tensor=True)
    for i in range(2):
        got, want = ours.get(i, random.Random(i)), ref.get(i, random.Random(i))
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            # the JAX side takes its native C++ crop+augment here (same draws,
            # /255 as a reciprocal multiply): within one f32 ulp of [0, 1]
            np.testing.assert_allclose(a, b, rtol=0, atol=6e-8)


def test_data_handler_counts_and_resumes():
    handler = DataHandler(_in_memory(PairedImageDataset)(_pairs(), 8, 2), 3, num_workers=1, seed=1)
    try:
        first = [handler.get_batch()[0] for _ in range(3)]
        assert handler.iterations == 3 and handler.is_main_process
        handler.set_iterations(1)
        np.testing.assert_array_equal(handler.get_batch()[0], first[1])
    finally:
        handler.close()


@pytest.mark.parametrize("name", ["l1", "l2", "mse", "charbonnier"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 5, 5, 3)).astype(np.float32), rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    got = losses.get_loss(name)(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_losses.get_loss(name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    ours, ref = losses.CharbonnierLoss(reduction="sum"), jax_losses.CharbonnierLoss(reduction="sum")
    np.testing.assert_allclose(ours(torch.from_numpy(a), torch.from_numpy(b)).item(), float(ref(a, b)), rtol=1e-5)


# -- the Trainer ----------------------------------------------------------------


class _FixedEvaluator:
    def run(self, inference):
        return 20.0, 0.5


def _trainer(ckpt, max_iters, seed=0, evaluator=None, **kw):
    model = SwinIR.build(**{**TINY, **kw.pop("cfg", {})}, seed=seed, device="cpu")
    dataset = _in_memory(PairedImageDataset)(_pairs(), 16, 2)
    return Trainer(model, dataset, evaluator=evaluator, batch_size=2, num_workers=1, max_iters=max_iters,
                   ckpt_path=str(ckpt), log_interval=1, **kw)


def test_trainer_resume_takes_the_same_step(tmp_path):
    """A run of 3 steps saves ``latest`` at step 2 and goes on; a new Trainer
    over a differently seeded model resumes from ``latest`` and takes step 3
    to the same weights, EMA and iteration."""
    a = _trainer(tmp_path, 3, eval_interval=2, ema_decay=0.5, milestones=[1])
    a.run()
    assert sorted(os.listdir(tmp_path)) == [
        "latest.ema.ckpt", "latest.model.ckpt", "latest.train.ckpt", "params.json", "train.log"
    ]
    b = _trainer(tmp_path, 3, seed=1, eval_interval=2, ema_decay=0.5, milestones=[1])
    b.run()
    assert b.data_handler.iterations == 3 and b.state.step == 3 and b.state.opt_state["count"] == 3
    for k, p in a.state.params.items():
        np.testing.assert_allclose(b.state.params[k].detach().numpy(), p.detach().numpy(), atol=1e-7, err_msg=k)
        np.testing.assert_allclose(b.state.ema_params[k].numpy(), a.state.ema_params[k].numpy(), atol=1e-7)


def test_trainer_falls_back_to_best_on_corrupt_latest(tmp_path):
    a = _trainer(tmp_path, 2, eval_interval=1, evaluator=_FixedEvaluator())
    a.run()
    saved = {k: v.clone() for k, v in a.model.module.state_dict().items()}
    with open(tmp_path / "latest.model.ckpt", "r+b") as f:
        f.truncate(100)
    b = _trainer(tmp_path, 2, seed=1, eval_interval=1)
    with pytest.warns(UserWarning, match="corrupt"):
        assert b.load("latest")
    assert b.best_psnr == 20.0
    for k, v in b.model.module.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)


def test_trainer_raises_on_config_drift(tmp_path):
    _trainer(tmp_path, 1, eval_interval=1).run()
    wider = _trainer(tmp_path, 1, eval_interval=1, cfg=dict(embed_dim=16))
    with pytest.raises(ValueError, match="drift"):
        wider.load("latest")


def test_trainer_fused_train_defaults_and_errors(tmp_path):
    assert _trainer(tmp_path, 1).fused_train is False  # off on the CPU
    assert _trainer(tmp_path, 1, fused_train=True).fused_train is True
    built_fused = SwinIR.build(**TINY, fused_train=True, device="cpu")
    with pytest.raises(ValueError, match="fused_train=False"):
        Trainer(built_fused, None, ckpt_path=str(tmp_path), fused_train=False)
    for option in ("profile_dir", "debug_nans"):
        with pytest.raises(NotImplementedError):
            _trainer(tmp_path, 1, **{option: "x"})


def test_fused_trainer_run_leaves_the_module_unfused(tmp_path):
    t = _trainer(tmp_path, 2, eval_interval=2, fused_train=True)
    t.run()
    assert t.model.module.fused_train is False and not t.model.module.training
    assert all(torch.isfinite(p).all() for p in t.state.params.values())
