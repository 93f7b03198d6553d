"""The rest of the port's user surface vs the JAX package on the CPU: the
image viewer's numpy core (``utils/compare.py``) bit for bit, its capture
through the port's PNG codec, ``Evaluator(visualize=True)``'s panels, the
``Model`` chainables and the export of the eval forward."""

import os
import sys

import numpy as np
import pytest
import torch

import studiosr_tpu.utils  # noqa: F401  (its ``compare`` attribute is the function; the module is in sys.modules)
from studiosr_tpu.engine.evaluator import Evaluator as JaxEvaluator
from studiosr_tpu_torch import Evaluator, SwinIR, VDSR
from studiosr_tpu_torch.utils import imread, imwrite
from studiosr_tpu_torch.utils.compare import ViewerState, _save_capture, compare, render

torch.set_num_threads(2)

jax_compare = sys.modules["studiosr_tpu.utils.compare"]
PORT_COMPARE = sys.modules["studiosr_tpu_torch.utils.compare"]
SMALL = dict(embed_dim=16, depths=[2, 2], num_heads=[2, 2], window_size=8, mlp_ratio=2.0)


def _images(n=3, h=40, w=56, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


# (label, a function of a ViewerState giving the state to render)
STATES = (
    ("centre", lambda s: s),
    ("corner cursor", lambda s: s.with_cursor(-3, 1000)),
    ("crop past the image", lambda s: s.with_crop_delta(+400)),
    ("crop at its floor", lambda s: s.with_crop_delta(-400).with_cursor(55, 39)),
    ("zoom down", lambda s: s.with_zoom_delta(-300)),
    ("diff", lambda s: s.toggled("show_diff").with_cursor(5, 5)),
    ("diff and psnr", lambda s: s.toggled("show_diff").toggled("show_psnr").with_zoom_delta(+8)),
)


@pytest.mark.parametrize("hooks", [False, True])
@pytest.mark.parametrize("label,move", STATES, ids=[s[0] for s in STATES])
def test_viewer_core_matches_jax_bit_for_bit(label, move, hooks):
    """``ViewerState`` transitions and ``render``'s panorama and zoomed strip,
    with the pure box and with recording cv2-style hooks."""
    images = _images()
    state = move(ViewerState(width=56, height=40, cursor=(28, 20), crop=16, zoom=64))
    jax_state = move(jax_compare.ViewerState(width=56, height=40, cursor=(28, 20), crop=16, zoom=64))
    assert state.crop_rect == jax_state.crop_rect and state.zoom == jax_state.zoom
    calls, jax_calls = [], []

    def recorder(log):
        return dict(draw_box=lambda img, p0, p1, c: log.append(("box", p0, p1, c)),
                    put_text=lambda img, text, org: log.append(("text", text, org))) if hooks else {}

    got = render(state, images, **recorder(calls))
    want = jax_compare.render(jax_state, images, **recorder(jax_calls))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert calls == jax_calls


def test_capture_is_the_png_cv2_writes(tmp_path):
    """The BGR strip is written through ``utils/png.py`` as the RGB PNG that
    the JAX package's ``cv2.imwrite`` writes."""
    cv2 = pytest.importorskip("cv2")
    _, strip = render(ViewerState(width=56, height=40, cursor=(10, 30), crop=16, zoom=48), _images(seed=1))
    path = _save_capture(strip, str(tmp_path / "captures"))
    assert path.endswith(".png") and os.path.dirname(path) == str(tmp_path / "captures")
    np.testing.assert_array_equal(imread(path), strip[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(path), strip)


def test_compare_needs_cv2_at_call_time(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        compare(_images())


def _layout(root, scale, n=2):
    """A GTmod12 / LRbicx{s} dataset of seeded images."""
    for d in ("GTmod12", f"LRbicx{scale}"):
        os.makedirs(os.path.join(root, d))
    for i, (hr,) in enumerate(zip(_images(n, 24, 36, seed=3))):
        imwrite(os.path.join(root, "GTmod12", f"{i}.png"), hr)
        imwrite(os.path.join(root, f"LRbicx{scale}", f"{i}.png"), hr[::scale, ::scale])


def test_evaluator_visualize_hands_the_jax_panels_to_the_viewer(tmp_path, monkeypatch):
    """``run(visualize=True)``: the nearest and bicubic upsamples (the port's
    resize), the SR and the HR image, in BGR, equal the JAX package's (cv2's
    resizes) bit for bit; the scores are the host route's, and with
    ``on_device=True`` the device metrics' on the model's device (no device
    pair: the SR image must come back)."""
    _layout(str(tmp_path / "set"), 2)
    shown, jax_shown = [], []
    monkeypatch.setattr(PORT_COMPARE, "compare", shown.append)
    monkeypatch.setattr(jax_compare, "compare", jax_shown.append)
    model = SwinIR.build(scale=2, **SMALL, device="cpu")
    port, ref = Evaluator("set", 2, root=str(tmp_path)), JaxEvaluator("set", 2, root=str(tmp_path))
    host = port.run(model)
    assert port.run(model, visualize=True) == host
    on_device = port.run(model, visualize=True, on_device=True)  # the metrics on the model's device
    assert abs(on_device[0] - host[0]) < 1e-4 and abs(on_device[1] - host[1]) < 1e-5
    assert ref.run(model.inference, visualize=True) == pytest.approx(host, abs=1e-9)
    assert len(shown) == 4 and len(jax_shown) == 2
    for panels, jax_panels in zip(shown[:2], jax_shown):
        assert len(panels) == len(jax_panels) == 4
        for got, want in zip(panels, jax_panels):
            np.testing.assert_array_equal(got, want)


def test_model_chainables():
    """``eval().to(device).astype(dtype)`` chains, as the reference's torch
    idiom does; ``to`` drops the cached fused-serving weights; ``half`` is
    ``astype(torch.bfloat16)``."""
    model = SwinIR.build(scale=2, **SMALL, device="cpu").enable_fused(True)
    prep = model.serving_prep()
    assert model.serving_prep() is prep
    model.module.train()
    same = model.eval().to("cpu").astype(torch.bfloat16)
    assert same is model and not model.module.training and model.device == torch.device("cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.module.parameters())
    assert model.serving_prep() is not prep and model.serving_prep()["blocks"][0][0]["wqkv"].dtype == torch.bfloat16
    assert model(torch.rand(1, 8, 8, 3)).dtype == torch.float32
    with pytest.raises(ValueError, match="unsupported device"):
        model.to("meta")
    assert model.astype(torch.float32).half() is model and model._compute_dtype == torch.bfloat16


@pytest.mark.parametrize("cls,kw", [(SwinIR, SMALL), (VDSR, dict(channels=8, n_layers=3))], ids=["swinir", "vdsr"])
def test_export_reloads_to_the_module(tmp_path, monkeypatch, cls, kw):
    """``Model.export`` saves the eval forward as a ``torch.export`` program
    (``{Class}x{scale}.pt2`` by default); reloaded, it equals the module on
    a 16² input."""
    monkeypatch.chdir(tmp_path)
    model = cls.build(scale=2, **kw, device="cpu")
    path = model.export(input_shape=[1, 16, 16, 3])
    assert path == f"{cls.__name__}x2.pt2" and os.path.exists(path)
    program = torch.export.load(path)
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_array_equal(program.module()(x).numpy(), model.module(x).numpy())


def test_export_onnx_needs_onnx(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "onnx", None)
    model = VDSR.build(scale=2, channels=8, n_layers=3, device="cpu")
    with pytest.raises(ImportError):
        model.export_onnx(str(tmp_path / "m.onnx"))
    assert not (tmp_path / "m.onnx").exists()
