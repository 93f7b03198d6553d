"""The port's user entry points vs the JAX package on the CPU: the model
contract (self-ensemble, on-device evaluation, tiled serving), the
Evaluator (both dataset layouts, the benchmark table, the download step)
and the CLI, on the trained fixtures (``tests/fixtures/quality``).

Tolerances: uint8 images within 1 LSB on under 1 % of pixels; on-device
scores within 1e-4 dB / 1e-5 of the JAX package's on-device scores and
within 1e-4 dB / 1e-4 of the host protocol; Evaluator averages within
0.01 dB of the JAX package's.
"""

import io
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from studiosr_tpu.__main__ import main as jax_main
from studiosr_tpu.engine.evaluator import Evaluator as JaxEvaluator
from studiosr_tpu.engine.evaluator import Evaluator2 as JaxEvaluator2
from studiosr_tpu.engine.evaluator import benchmark as jax_benchmark
from studiosr_tpu.parallel.tiled import tiled_inference as jax_tiled_inference
from studiosr_tpu.utils.helpers import imread as jax_imread
from studiosr_tpu.utils.metrics import compute_psnr, compute_ssim
from studiosr_tpu.zoo.registry import load_model as jax_load_model
from studiosr_tpu_torch import Evaluator, Evaluator2, Trainer, benchmark, load_model
from studiosr_tpu_torch.__main__ import main
from studiosr_tpu_torch.parallel import get_mesh, tile_grid
from studiosr_tpu_torch.utils import helpers, imread, imwrite

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
SWINIR_X2 = os.path.join(FIXTURES, "swinir_x2_ckpt")
SWINIR_X4 = os.path.join(FIXTURES, "swinir_ckpt")


def _close_uint8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.fixture(scope="module")
def x2_pair():
    return jax_load_model(SWINIR_X2, "swinir"), load_model(SWINIR_X2, "swinir", device="cpu")


def _fixture(i, lr="_lrx2"):
    return imread(os.path.join(FIXTURES, f"img{i}{lr}.png")), imread(os.path.join(FIXTURES, f"img{i}_hr.png"))


def test_self_ensemble_matches_jax(x2_pair):
    jax_model, model = x2_pair
    lr, _ = _fixture(1)
    _close_uint8(model.inference_with_self_ensemble(lr), jax_model.inference_with_self_ensemble(lr))


@pytest.mark.parametrize("crop_border,y_only,lr", [(2, True, "_lrx2"), (0, False, "_lrx2"), (3, True, "_lrx3")])
def test_evaluate_uint8_matches_jax_and_the_host_protocol(crop_border, y_only, lr):
    """The x3 case serves 42 x 42 -> 126 x 126 against a 128 x 128 GT: the
    Set14 situation, cropped to a common size before the border crop."""
    ckpt = os.path.join(FIXTURES, f"swinir_x{lr[-1]}_ckpt")
    jax_model, model = jax_load_model(ckpt, "swinir"), load_model(ckpt, "swinir", device="cpu")
    for i in range(3):
        lq, gt = _fixture(i, lr)
        got = model.evaluate_uint8(lq, gt, crop_border=crop_border, y_only=y_only)
        want = jax_model.evaluate_uint8(lq, gt, crop_border=crop_border, y_only=y_only)
        assert abs(got[0] - want[0]) < 1e-4 and abs(got[1] - want[1]) < 1e-5, (got, want)
        sr = model.inference(lq)
        assert abs(got[0] - compute_psnr(sr, gt, y_only, crop_border)) < 1e-4
        assert abs(got[1] - compute_ssim(sr, gt, y_only, crop_border)) < 1e-4


def test_evaluate_uint8_batch_matches_jax(x2_pair):
    jax_model, model = x2_pair
    lqs, gts = zip(*[_fixture(i) for i in range(3)])
    got = model.evaluate_uint8_batch(np.stack(lqs), np.stack(gts), crop_border=2)
    want = jax_model.evaluate_uint8_batch(np.stack(lqs), np.stack(gts), crop_border=2)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    # over a mesh of the model's own device: the mesh-less numbers; a mesh on another device raises
    meshed = model.evaluate_uint8_batch(np.stack(lqs), np.stack(gts), crop_border=2, mesh=get_mesh(["cpu", "cpu"]))
    np.testing.assert_array_equal(meshed[0], got[0])
    np.testing.assert_array_equal(meshed[1], got[1])
    with pytest.raises(ValueError, match="lives on"):
        model.evaluate_uint8_batch(np.stack(lqs), np.stack(gts), mesh=get_mesh(["meta"]))


@pytest.mark.parametrize("tile,overlap,batch", [(32, 8, 4), (24, 4, 3), (100, 16, 8)])
def test_inference_tiled_matches_jax_host_loop(x2_pair, tile, overlap, batch):
    jax_model, model = x2_pair
    lr = np.concatenate([_fixture(0)[0], _fixture(1)[0][:20]], axis=0)  # 84 x 64: a ragged tail row of tiles
    want = jax_tiled_inference(jax_model, lr, tile=tile, tile_overlap=overlap, tile_batch=batch, device_loop=False)
    _close_uint8(model.inference_tiled(lr, tile=tile, tile_overlap=overlap, tile_batch=batch), want)


def test_tiled_modes_without_a_port_raise(x2_pair):
    _, model = x2_pair
    lr = _fixture(0)[0]
    with pytest.raises(NotImplementedError, match="device_loop"):
        model.inference_tiled(lr, tile=32, device_loop=True)
    # tiles over a mesh of the model's own device: the mesh-less output
    np.testing.assert_array_equal(model.inference_tiled(lr, tile=32, tile_batch=4, mesh=get_mesh(["cpu", "cpu"])),
                                  model.inference_tiled(lr, tile=32, tile_batch=4))
    with pytest.raises(ValueError, match="lives on"):
        model.inference_tiled(lr, tile=32, mesh=get_mesh(["meta"]))
    np.testing.assert_array_equal(tile_grid(84, 32, 16), [0, 16, 32, 48, 52])


# -- the Evaluator --------------------------------------------------------------


@pytest.mark.parametrize("eval_on_device", [None, False, True])
def test_trainer_eval_on_device_routes(tmp_path, x2_pair, eval_on_device):
    """``Trainer(eval_on_device=...)``, the JAX Trainer's argument: True
    scores through ``evaluator.run(model, on_device=True)`` (here on the
    CPU device), False and None (a model on the CPU) on the host; the routes
    agree to 1e-4 dB and 1e-5 SSIM."""
    _, model = x2_pair
    _layout(str(tmp_path / "fixture"), "evaluator2", 2)
    ev = Evaluator2("fixture", 2, root=str(tmp_path))
    routes = []
    run = ev.run
    ev.run = lambda fn, **kw: routes.append(kw.get("on_device", False)) or run(fn, **kw)
    trainer = Trainer(model, None, evaluator=ev, ckpt_path=str(tmp_path / "run"), bfloat16=False,
                      eval_on_device=eval_on_device)
    psnr, ssim = trainer.evaluate()
    assert routes == [bool(eval_on_device)]
    host = run(model.inference)
    assert abs(psnr - host[0]) < 1e-4 and abs(ssim - host[1]) < 1e-5


@pytest.mark.parametrize("name", ["swinfir", "maxsr"])
def test_registry_builds_swinfir_and_maxsr(name):
    from studiosr_tpu.zoo.registry import get_model_class as jax_get_model_class
    from studiosr_tpu_torch.zoo import get_model_class

    cls = get_model_class(name)
    assert cls.__name__ == jax_get_model_class(name).__name__
    model = cls.build(scale=2, device="cpu", **(
        dict(embed_dim=16, depths=[2], num_heads=[2]) if name == "swinfir" else dict(dim=16, dim_head=8, depth=[1])))
    assert model(torch.zeros(1, 8, 8, 3)).shape == (1, 16, 16, 3)


def _layout(root, kind, scale, names=("img0", "img1", "img2")):
    """A dataset directory from the fixture PNGs: ``evaluator2`` is the
    HR / LR_bicubic/X{s} layout, ``evaluator`` the GTmod12 / LRbicx{s} one."""
    hr_dir, lr_dir = (("HR", f"LR_bicubic/X{scale}") if kind == "evaluator2" else ("GTmod12", f"LRbicx{scale}"))
    os.makedirs(os.path.join(root, hr_dir)), os.makedirs(os.path.join(root, lr_dir))
    for name in names:
        imwrite(os.path.join(root, hr_dir, f"{name}.png"), imread(os.path.join(FIXTURES, f"{name}_hr.png")))
        imwrite(os.path.join(root, lr_dir, f"{name}.png"), imread(os.path.join(FIXTURES, f"{name}_lrx{scale}.png")))


@pytest.mark.parametrize("kind", ["evaluator", "evaluator2"])
def test_evaluator_matches_jax_on_both_layouts(tmp_path, x2_pair, kind):
    jax_model, model = x2_pair
    _layout(str(tmp_path / "fixture"), kind, 2)
    cls, jax_cls = (Evaluator, JaxEvaluator) if kind == "evaluator" else (Evaluator2, JaxEvaluator2)
    port, ref = cls("fixture", 2, root=str(tmp_path)), jax_cls("fixture", 2, root=str(tmp_path))
    want = ref.run(jax_model)
    host = port.run(model)
    assert abs(host[0] - want[0]) < 0.01 and abs(host[1] - want[1]) < 1e-3
    on_device = port.run(model, on_device=True)
    assert abs(on_device[0] - host[0]) < 1e-4 and abs(on_device[1] - host[1]) < 1e-5
    if not torch.cuda.is_available():  # a bare callable's on-device scores are taken on the card
        with pytest.raises(RuntimeError, match="CUDA"):
            port.run(model.inference, on_device=True)
    shown = []  # visualize=True hands each image's panels to the viewer and scores as the host route does
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys.modules["studiosr_tpu_torch.utils.compare"], "compare", shown.append)
        assert port.run(model, visualize=True) == host
    assert len(shown) == len(port.testset) and all(len(panels) == 4 for panels in shown)


def test_benchmark_table(tmp_path, monkeypatch, capsys, x2_pair):
    jax_model, model = x2_pair
    monkeypatch.chdir(tmp_path)
    for name in ("SetA", "SetB"):
        _layout(os.path.join("dataset", "benchmark", name), "evaluator2", 2, names=("img0", "img2") if name == "SetA"
                else ("img1",))
    psnrs, ssims = benchmark(model, scale=2, datasets=["SetA", "SetB"], on_device=True)
    table = capsys.readouterr().out.splitlines()
    want = jax_benchmark(jax_model, scale=2, datasets=["SetA", "SetB"])
    np.testing.assert_allclose(psnrs, want[0], atol=0.01)
    np.testing.assert_allclose(ssims, want[1], atol=1e-3)
    assert "| Metric |       SetA |       SetB |" in table
    assert "|   PSNR | %10.3f | %10.3f |" % tuple(psnrs) in table
    assert "|   SSIM | %10.4f | %10.4f |" % tuple(ssims) in table


class _Response(io.BytesIO):
    def __init__(self, body: bytes, content_type: str):
        super().__init__(body)
        self.headers = {"content-type": content_type}


class _Opener:
    """Serves a confirm-form HTML page, then the file, as Google Drive does
    for large files; records the URLs it was asked for."""

    def __init__(self, payload: bytes, html_again: bool = False):
        self.payload, self.html_again, self.urls, self.handlers = payload, html_again, [], []

    def open(self, url, timeout=None):
        self.urls.append(url)
        if len(self.urls) == 1 or self.html_again:
            form = '<form action="https://drive.example/download"><input name="confirm" value="t0k"></form>'
            return _Response(form.encode(), "text/html; charset=utf-8")
        return _Response(self.payload, "application/zip")


def test_evaluator_downloads_a_missing_dataset(tmp_path, monkeypatch, x2_pair):
    _, model = x2_pair
    _layout(str(tmp_path / "src" / "Set5"), "evaluator2", 2, names=("img0",))
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w") as z:
        for dirpath, _, files in os.walk(tmp_path / "src"):
            for f in files:
                full = os.path.join(dirpath, f)
                z.write(full, os.path.relpath(full, tmp_path / "src"))
    opener = _Opener(buffer.getvalue())
    monkeypatch.setattr(helpers, "_build_opener", lambda: opener)
    ev = Evaluator2("Set5", 2, root=str(tmp_path / "dl"))
    assert "id=1ewFsDc-FdxierrNv8bGp4tE1BJzccyyr" in opener.urls[0]
    assert opener.urls[1].startswith("https://drive.example/download?") and "confirm=t0k" in opener.urls[1]
    assert len(ev.testset) == 1 and ev.run(model)[0] > 20
    monkeypatch.setattr(helpers, "_build_opener", lambda: _Opener(b"", html_again=True))
    with pytest.raises(IOError, match="HTML page"):
        Evaluator2("Set14", 2, root=str(tmp_path / "dl2"))
    assert not os.path.exists(tmp_path / "dl2" / "Set14")


# -- the CLI ----------------------------------------------------------------------


def _cli(monkeypatch, entry, argv):
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    entry()


def test_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    imwrite(str(src / "a.png"), imread(os.path.join(FIXTURES, "img0_lrx4.png")))
    imwrite(str(src / "sub" / "a.png"), imread(os.path.join(FIXTURES, "img1_lrx4.png")))
    imwrite(str(src / "b.png"), imread(os.path.join(FIXTURES, "img2_lrx4.png")))
    base = ["--image", str(src), "--scale", "4", "--model", "swinir", "--ckpt", SWINIR_X4]
    _cli(monkeypatch, jax_main, base + ["--output", str(tmp_path / "jax")])
    names = ["a.swinir_x4.png", "b.swinir_x4.png", "sub__a.swinir_x4.png"]
    # the output directory inside the input: a second run skips the first one's outputs
    for _ in range(2):
        _cli(monkeypatch, main, base + ["--output", str(src / "whole"), "--device", "cpu"])
        assert sorted(os.listdir(src / "whole")) == names
    (src / "whole").rename(tmp_path / "whole")
    for extra, out in (["--batch", "2"], "batch"), (["--self-ensemble"], "ensemble"):
        _cli(monkeypatch, main, base + ["--output", str(tmp_path / out), "--device", "cpu"] + extra)
        assert sorted(os.listdir(tmp_path / out)) == names
    for name in names:
        want = jax_imread(str(tmp_path / "jax" / name))
        _close_uint8(imread(str(tmp_path / "whole" / name)), want)
        np.testing.assert_array_equal(imread(str(tmp_path / "batch" / name)), imread(str(tmp_path / "whole" / name)))
    jax_model = jax_load_model(SWINIR_X4, "swinir")
    _close_uint8(imread(str(tmp_path / "ensemble" / names[0])), jax_model.inference_with_self_ensemble(
        imread(str(src / "a.png"))))


def test_cli_tiled_half_and_errors(tmp_path, monkeypatch):
    img = os.path.join(FIXTURES, "img1_lrx4.png")
    base = ["--image", img, "--scale", "4", "--model", "swinir", "--ckpt", SWINIR_X4, "--device", "cpu"]
    _cli(monkeypatch, main, base + ["--output", str(tmp_path / "w"), "--half"])
    _cli(monkeypatch, main, base + ["--output", str(tmp_path / "t"), "--half", "--tile", "16", "--tile-overlap", "4"])
    hr = imread(os.path.join(FIXTURES, "img1_hr.png"))
    whole, tiled = (imread(str(tmp_path / d / "img1_lrx4.swinir_x4.png")) for d in ("w", "t"))
    assert compute_psnr(tiled, hr) > compute_psnr(whole, hr) - 0.5
    with pytest.raises(SystemExit):  # argparse error: the checkpoint is x4
        _cli(monkeypatch, main, base[:3] + ["2"] + base[4:] + ["--output", str(tmp_path / "x")])
    # without --ckpt the CLI serves the release file under ./pretrained, and reaches for the network without it
    monkeypatch.chdir(tmp_path)

    def offline(*args, **kwargs):
        raise ConnectionError("offline")

    monkeypatch.setattr(helpers, "download_gdrive", offline)
    with pytest.raises(ConnectionError, match="offline"):
        _cli(monkeypatch, main, ["--image", img, "--model", "hat", "--output", str(tmp_path / "z"), "--device", "cpu"])
