"""The port's training surface on the CPU: the Trainer's ``profile_dir`` and
``debug_nans``, dropout in plain autograd, and ``scripts/torch_train.py``.

* ``profile_dir`` writes a Chrome trace of 2 steps of a narrow SwinIR;
* ``debug_nans`` raises ``FloatingPointError`` naming the iteration and the
  non-finite loss or gradient, and leaves a finite run's state bit for bit;
* dropout keeps 1 - p of the elements, scales them by 1 / (1 - p), is the
  identity in eval mode and draws from the step's generator; ``fused_train``
  refuses ``drop_rate > 0`` as the JAX package does;
* the entry point mirrors ``tests/test_train_script.py`` (dataset and
  evaluator stubbed: the recipe, EMA and grad-accum wiring, ``--multihost``)
  and trains once on a real tiny DIV2K layout, checkpoints, traces and
  resumes.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from studiosr_tpu_torch import HAT, SwinFIR, SwinIR, Trainer, native
from studiosr_tpu_torch.data import PairedImageDataset
from studiosr_tpu_torch.models.blocks import Mlp, dropout, gelu
from studiosr_tpu_torch.utils import imread, imwrite
from studiosr_tpu_torch.utils.png import write_png

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "quality"
NARROW = dict(scale=2, embed_dim=8, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0,
              upsampler="pixelshuffledirect")


class _Pairs(PairedImageDataset):
    """Seeded uint8 pairs held in memory, the standard training pipeline."""

    def __init__(self, n=4, lr=20, scale=2, size=8):
        rng = np.random.default_rng(0)
        self.pairs = [(rng.integers(0, 256, (lr, lr, 3), dtype=np.uint8),
                       rng.integers(0, 256, (lr * scale, lr * scale, 3), dtype=np.uint8)) for _ in range(n)]
        self.files = [str(i) for i in range(n)]
        self._init_pipeline(size, scale, True, False)

    def get_image_pair(self, idx):
        return self.pairs[idx]


def _trainer(tmp_path, steps=2, model=None, **kw):
    model = model or SwinIR.build(**NARROW, device="cpu")
    return Trainer(model, _Pairs(), batch_size=2, num_workers=1, max_iters=steps, eval_interval=steps,
                   ckpt_path=str(tmp_path / "ckpt"), log_interval=1, **kw)


# -- profile_dir and debug_nans ---------------------------------------------------------


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    t = _trainer(tmp_path, profile_dir=str(tmp_path / "trace"))
    t.run()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)  # the steps' host ops
    assert len(t.timings["get_batch"]) == len(t.timings["step"]) == 2


def test_debug_nans_leaves_a_finite_run_bitwise(tmp_path):
    a = _trainer(tmp_path / "a", debug_nans=True)
    b = _trainer(tmp_path / "b")
    a.run()
    b.run()
    for (k, p), q in zip(a.model.module.state_dict().items(), b.model.module.state_dict().values()):
        assert torch.equal(p, q), k
    for k, v in a.state.opt_state["nu"].items():
        assert torch.equal(v, b.state.opt_state["nu"][k])


def test_debug_nans_names_a_non_finite_loss(tmp_path):
    model = SwinIR.build(**NARROW, device="cpu")
    with torch.no_grad():
        model.module.conv_first.weight[0, 0, 0, 0] = float("nan")
    t = _trainer(tmp_path, model=model, debug_nans=True)
    before = model.module.conv_first.bias.detach().clone()
    with pytest.raises(FloatingPointError, match=r"iteration 1: non-finite loss"):
        t.run()
    assert torch.equal(model.module.conv_first.bias, before)  # raised before the update


def test_debug_nans_names_the_first_non_finite_gradient(tmp_path):
    model = SwinIR.build(**NARROW, device="cpu")
    names = [k for k, _ in model.module.named_parameters()]
    target = names[5]
    dict(model.module.named_parameters())[target].register_hook(lambda g: g * float("inf"))
    t = _trainer(tmp_path, model=model, debug_nans=True)
    with pytest.raises(FloatingPointError, match=rf"iteration 1: non-finite gradient of {target}$"):
        t.run()
    # without the flag the same step goes through (and poisons the weights)
    _trainer(tmp_path / "off", model=model).run()
    assert not torch.isfinite(dict(model.module.named_parameters())[target]).all()


# -- dropout ----------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.full((64, 64, 32), 3.0)
    y = dropout(x, rate, True, torch.Generator().manual_seed(7))
    kept = y != 0
    assert set(torch.unique(y).tolist()) == {0.0, float(torch.tensor(3.0) / (1.0 - rate))}
    assert abs(float(kept.float().mean()) - (1.0 - rate)) < 0.01  # 131,072 draws: sd 0.0015 at most
    assert torch.equal(y, dropout(x, rate, True, torch.Generator().manual_seed(7)))  # the generator's function
    assert not torch.equal(y, dropout(x, rate, True, torch.Generator().manual_seed(8)))


def test_dropout_is_the_identity_out_of_training():
    x = torch.randn(2, 5, 7)
    assert dropout(x, 0.3, False) is x and dropout(x, 0.0, True) is x
    assert torch.equal(dropout(x, 1.0, True), torch.zeros_like(x))
    dropped = SwinIR.build(**NARROW, drop_rate=0.3, seed=3, device="cpu")
    plain = SwinIR.build(**NARROW, seed=3, device="cpu")
    img = torch.rand(1, 12, 12, 3)
    with torch.no_grad():
        assert torch.equal(dropped.module(img), plain.module(img))


def test_mlp_drops_after_the_gelu_and_after_fc2():
    mlp = Mlp(6, 10, drop=0.4).train()
    x = torch.randn(3, 6)
    g = torch.Generator().manual_seed(2)
    want = dropout(mlp.fc2(dropout(gelu(mlp.fc1(x)), 0.4, True, g)), 0.4, True, g)
    assert torch.equal(mlp(x, torch.Generator().manual_seed(2)), want)
    assert torch.equal(mlp.eval()(x), mlp.fc2(gelu(mlp.fc1(x))))


@pytest.mark.parametrize("cls,cfg", [
    (SwinIR, NARROW),
    (HAT, dict(scale=2, embed_dim=16, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0,
               compress_ratio=2, squeeze_factor=4)),
    (SwinFIR, dict(scale=2, embed_dim=8, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0)),
], ids=["swinir", "hat", "swinfir"])
def test_dropout_trains_in_plain_autograd_and_fused_train_refuses_it(cls, cfg, tmp_path):
    model = cls.build(**cfg, drop_rate=0.2, device="cpu")
    with pytest.raises(NotImplementedError, match="drop==0"):
        model.module.fused_train = True
    with pytest.raises(NotImplementedError, match="drop==0"):
        _trainer(tmp_path / "fused", model=model, fused_train=True)
    module = model.module.train()
    x = torch.rand(2, 16, 16, 3)
    a = module(x, generator=torch.Generator().manual_seed(1))
    b = module(x, generator=torch.Generator().manual_seed(1))
    c = module(x, generator=torch.Generator().manual_seed(2))
    module.eval()
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    t = _trainer(tmp_path, model=model)
    assert t.fused_train is False  # the default declines a drop_rate
    before = {k: p.detach().clone() for k, p in model.module.named_parameters()}
    t.run()
    assert all(not torch.equal(p, before[k]) for k, p in model.module.named_parameters() if "bias" in k)


# -- scripts/torch_train.py -------------------------------------------------------------


def _train_script():
    spec = importlib.util.spec_from_file_location("torch_train_script", ROOT / "scripts" / "torch_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _SyntheticPairs:
    """Stands in for data.DIV2K: its constructor, tensor pairs as
    transform=True / to_tensor=True give them."""

    def __init__(self, data_dir, size=16, scale=2, transform=True, to_tensor=True, download=False):
        assert transform and to_tensor and not download
        self.size, self.scale = size, scale
        self.rng = np.random.RandomState(0)

    def __len__(self):
        return 64

    def __getitem__(self, i):
        gt = self.rng.rand(self.size * self.scale, self.size * self.scale, 3).astype(np.float32)
        lq = gt.reshape(self.size, self.scale, self.size, self.scale, 3).mean(axis=(1, 3))
        return lq, gt


class _StubEvaluator:
    def __init__(self, dataset, scale=4, root="dataset"):
        self.dataset, self.scale, self.root = dataset, scale, root
        self.calls = 0

    def run(self, func, *a, **kw):
        _StubEvaluator.last = self
        self.calls += 1
        sr = func((np.random.RandomState(1).rand(8, 8, 3) * 255).astype(np.uint8))
        assert sr.dtype == np.uint8 and sr.shape == (8 * self.scale, 8 * self.scale, 3)
        return 30.0 + self.calls, 0.9


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_script_wires_the_recipe(tmp_path, monkeypatch, grad_accum):
    import studiosr_tpu_torch.data as data
    import studiosr_tpu_torch.engine as engine

    mod = _train_script()
    monkeypatch.setattr(data, "DIV2K", _SyntheticPairs)
    monkeypatch.setattr(engine, "Evaluator", _StubEvaluator)
    ckpt = tmp_path / "ckpt"
    trainer = mod.main(["--model", "espcn", "--scale", "2", "--size", "8", "--max-iters", "2", "--batch-size", "8",
                        "--eval-interval", "2", "--ckpt", str(ckpt), "--ema-decay", "0.9", "--grad-accum",
                        str(grad_accum), "--data-dir", str(tmp_path / "data"), "--device", "cpu"])
    files = sorted(os.listdir(ckpt))
    assert "params.json" in files and "train.log" in files
    assert any(f.endswith(".model.ckpt") for f in files) and any(f.endswith(".ema.ckpt") for f in files)
    assert _StubEvaluator.last.calls >= 1 and _StubEvaluator.last.root == str(tmp_path / "data")
    recipe = trainer.model.get_training_config()
    assert (trainer.batch_size, trainer.max_iters, trainer.ema_decay) == (8, 2, 0.9)
    assert trainer.tx.accum_steps == grad_accum and trainer.milestones == list(recipe["milestones"])
    assert trainer.device.type == "cpu" and trainer.data_handler.iterations == 2


def test_train_script_multihost_waits_for_a17():
    with pytest.raises(NotImplementedError, match="A17"):
        _train_script().main(["--multihost", "--device", "cpu"])


def _tiny_div2k(root):
    """DIV2K's layout: one 600² HR image (Paeth rows) with its X2 / X3 / X4
    LR, and a DIV2K_mini evaluation set from the quality fixtures."""
    rng = np.random.default_rng(0)
    hr = rng.integers(0, 256, (600, 600, 3), dtype=np.uint8)
    base = root / "DIV2K"
    (base / "DIV2K_train_HR").mkdir(parents=True)
    write_png(str(base / "DIV2K_train_HR" / "0001.png"), hr, row_filter=4)
    for s in (2, 3, 4):
        d = base / "DIV2K_train_LR_bicubic" / f"X{s}"
        d.mkdir(parents=True)
        lr = hr.reshape(600 // s, s, 600 // s, s, 3).mean(axis=(1, 3)).astype(np.uint8)
        write_png(str(d / f"0001x{s}.png"), lr, row_filter=4)
    for sub, name in (("GTmod12", "img0_hr.png"), ("LRbicx4", "img0_lrx4.png")):
        (root / "DIV2K_mini" / sub).mkdir(parents=True)
        imwrite(str(root / "DIV2K_mini" / sub / "img0.png"), imread(str(FIXTURES / name)))


def test_train_script_trains_on_a_tiny_div2k_layout(tmp_path, monkeypatch):
    """A narrow SwinIR x4 through the real DIV2K class and Evaluator: the
    packs are prepared, the native crop-augment and unfilter run, best /
    latest and a trace are written, and a longer run resumes at iteration 2."""
    import studiosr_tpu_torch.zoo.registry as registry

    class Narrow(SwinIR):
        @classmethod
        def build(cls, scale=4, device=None):
            return SwinIR.build(**{**NARROW, "scale": scale, "upsampler": "pixelshuffle"}, device=device)

    monkeypatch.setattr(registry, "get_model_class", lambda name: Narrow)
    _tiny_div2k(tmp_path / "data")
    args = ["--model", "swinir", "--scale", "4", "--dataset", "DIV2K", "--data-dir", str(tmp_path / "data"),
            "--size", "16", "--batch-size", "2", "--eval-interval", "2", "--ckpt", str(tmp_path / "ckpt"),
            "--device", "cpu"]
    native.reset_counters()
    first = _train_script().main(args + ["--max-iters", "2", "--profile-dir", str(tmp_path / "trace")])
    counts = native.counters()
    assert counts["crop_augment"].get("numpy", 0) == 0 and counts["crop_augment"]["native"] >= 4
    assert counts["unfilter"].get("python", 0) == 0
    sub = tmp_path / "data" / "DIV2K" / "sub"
    assert len(list((sub / "DIV2K_train_HR").iterdir())) == 4
    assert all(len(list((sub / "DIV2K_train_LR_bicubic" / f"X{s}").iterdir())) == 4 for s in (2, 3, 4))
    files = set(os.listdir(tmp_path / "ckpt"))
    assert {"best.model.ckpt", "latest.model.ckpt", "latest.train.ckpt", "params.json"} <= files
    assert first.best_psnr > 0 and len(list((tmp_path / "trace").glob("*.json"))) == 1
    resumed = _train_script().main(args + ["--max-iters", "3"])
    assert resumed.data_handler.iterations == 3 and len(resumed.timings["step"]) == 1
