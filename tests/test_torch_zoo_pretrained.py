"""The published-weight zoo, offline: ``from_pretrained`` of every family
and release the JAX package reads, on a release-layout file written under
``./pretrained`` from the JAX model's ``export_state_dict`` (the release's
wrapper key, ``module.`` prefixes for IMDN, the recomputed buffers, one key
of another model and, for the non-strict loads, one parameter left out).

Both packages' ``download``, ``download_gdrive`` and ``gdown_and_extract``
are patched to raise, so nothing reaches the network. The port's parameters
are held bit for bit against the JAX package's, carried across by
``load_jax_params``; the two ``TranslationReport``s must name the same keys.
Full-width models are compared by their parameters only, with no forward."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import studiosr_tpu.models as jax_models
import studiosr_tpu.models.base as jax_base
import studiosr_tpu.utils.helpers as jax_helpers
import studiosr_tpu_torch.models as models
from studiosr_tpu.zoo.translate import export_state_dict
from studiosr_tpu.zoo.translate import load_torch_state_dict as jax_load_torch_state_dict
from studiosr_tpu.zoo.translate import translate_state_dict as jax_translate_state_dict
from studiosr_tpu_torch.utils import helpers, imread, imwrite
from studiosr_tpu_torch.zoo import TranslationReport, fetch, load_jax_params, load_torch_state_dict, translate_state_dict

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "quality"
UNKNOWN = "tail.unreleased.weight"  # a key no module here has: reported unused, never fatal
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "embedding": "weight", "alpha": "weight",
                  "mean": "running_mean", "var": "running_var"}


def _swinir_file(scale, variant):
    if variant == "light":
        return f"002_lightweightSR_DIV2K_s64w8_SwinIR-S_x{scale}.pth"
    return f"001_classicalSR_{variant}_s{64 if variant == 'DF2K' else 48}w8_SwinIR-M_x{scale}.pth"


# (family, scale, variant) -> what the release holds
RELEASES = {
    "swinir": dict(cls="SwinIR", wrapper="params", strict=False, file=_swinir_file),
    "hat": dict(cls="HAT", wrapper="params_ema", strict=True, file=lambda s, v: f"HAT_SRx{s}.pth"),
    "edsr": dict(cls="EDSR", wrapper=None, strict=True,
                 file=lambda s, v: f"r32f256x{s}.pth" if v == "DIV2K" else f"EDSRx{s}.pth"),
    "han": dict(cls="HAN", wrapper=None, strict=False, file=lambda s, v: f"HAN_BIX{s}.pt"),
    "imdn": dict(cls="IMDN", wrapper=None, strict=True, file=lambda s, v: f"IMDN_x{s}.pth"),
    "rcan": dict(cls="RCAN", wrapper=None, strict=False, file=lambda s, v: f"models_ECCV2018RCAN/RCAN_BIX{s}.pt"),
    "vdsr": dict(cls="VDSR", wrapper=None, strict=True, file=lambda s, v: f"VDSRx{s}.pth"),
}
CASES = ([("swinir", s, "DF2K") for s in (2, 3, 4, 8)] + [("swinir", 4, "DIV2K")]
         + [("swinir", s, "light") for s in (2, 3, 4)] + [("hat", s, None) for s in (2, 3, 4)]
         + [("edsr", s, d) for d in ("DIV2K", "DF2K") for s in (2, 3, 4)] + [("han", s, None) for s in (2, 3, 4, 8)]
         + [("imdn", s, None) for s in (2, 3, 4)] + [("rcan", s, None) for s in (2, 3, 4)]
         + [("vdsr", s, None) for s in (2, 3, 4)])


def _build_kwargs(family, scale, variant) -> dict:
    """The release's configuration, as both packages' ``from_pretrained`` build it."""
    kw = {"scale": scale}
    if family == "swinir" and variant == "light":
        kw.update(depths=[6, 6, 6, 6], embed_dim=60, num_heads=[6, 6, 6, 6], upsampler="pixelshuffledirect")
    if (family == "edsr" and variant == "DIV2K") or family in ("han", "rcan"):
        kw["img_range"] = 255.0
    return kw


def _pretrained_kwargs(family, variant) -> dict:
    if family == "swinir":
        return {"light": True} if variant == "light" else {"dataset": variant}
    return {"dataset": variant} if family == "edsr" else {}


def _recomputed(family, state) -> dict:
    """The buffers a release holds that both packages recompute: SwinIR's and
    HAT's rel-pos indices and shift masks, the frozen MeanShift convs."""
    extra = {}
    if family in ("swinir", "hat"):
        ws = 16 if family == "hat" else 8
        blocks = sorted({k.split(".attn.")[0] for k in state if ".residual_group.blocks." in k and ".attn." in k})
        for i, prefix in enumerate(blocks):
            extra[f"{prefix}.attn.relative_position_index"] = torch.zeros(ws * ws, ws * ws, dtype=torch.int64)
            if i % 2:
                extra[f"{prefix}.attn_mask"] = torch.zeros(4, ws * ws, ws * ws)
        if family == "hat":
            extra["relative_position_index_SA"] = torch.zeros(ws * ws, ws * ws, dtype=torch.int64)
            extra["relative_position_index_OCA"] = torch.zeros(ws * ws, 24 * 24, dtype=torch.int64)
    if family in ("edsr", "han", "rcan"):
        for name in ("sub_mean", "add_mean"):
            extra[f"{name}.weight"] = torch.eye(3).reshape(3, 3, 1, 1)
            extra[f"{name}.bias"] = torch.zeros(3)
    return extra


def _offline(monkeypatch):
    """Patch both packages' downloads to raise, and let the JAX package's
    shape-only initialisation (zeros of the module's shapes, which the
    release overwrites) trace each configuration once a test, not once for
    the file and again for ``from_pretrained``."""

    def refuse(*args, **kwargs):
        raise ConnectionError("the tests reach no network")

    for module in (helpers, jax_helpers):
        for name in ("download", "download_gdrive", "gdown_and_extract"):
            monkeypatch.setattr(module, name, refuse)
    cache, traced = {}, jax_base.fast_init_variables

    def fast_init_variables(module, x_shape, seed=0):
        key = (repr(module), tuple(x_shape), seed)
        if key not in cache:
            cache[key] = traced(module, x_shape, seed)
        return cache[key]

    monkeypatch.setattr(jax_base, "fast_init_variables", fast_init_variables)


def _write_release(family, scale, variant, directory: Path, seed: int = 0) -> tuple:
    """Write the release-layout file under ``directory / "pretrained"`` from a
    JAX model of the release's configuration with seeded values. Returns
    (path, the parameter left out or None)."""
    spec = RELEASES[family]
    jax_cls = getattr(jax_models, spec["cls"])
    template = jax_cls.build(**_build_kwargs(family, scale, variant), fast_init=True).variables
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(a.dtype), template)
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in export_state_dict(variables).items()}
    left_out = sorted(state)[-1] if not spec["strict"] else None
    if left_out:
        del state[left_out]
    state.update(_recomputed(family, state))
    state[UNKNOWN] = torch.zeros(3)
    if family == "imdn":
        state = {f"module.{k}": v for k, v in state.items()}
    path = directory / "pretrained" / spec["file"](scale, variant)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state if spec["wrapper"] is None else {spec["wrapper"]: state, "iter": 1}, path)
    return path, left_out


def _torch_name(flax_path: str) -> str:
    prefix, _, leaf = flax_path.rpartition(".")
    return f"{prefix}.{_LEAF_TO_TORCH.get(leaf, leaf)}"


@pytest.mark.parametrize("family,scale,variant", CASES, ids=[f"{f}-x{s}-{v}" for f, s, v in CASES])
def test_from_pretrained_matches_jax(tmp_path, monkeypatch, capsys, family, scale, variant):
    _offline(monkeypatch)
    path, left_out = _write_release(family, scale, variant, tmp_path)
    monkeypatch.chdir(tmp_path)
    spec = RELEASES[family]
    kw = _pretrained_kwargs(family, variant)
    jax_model = getattr(jax_models, spec["cls"]).from_pretrained(scale=scale, **kw)
    model = getattr(models, spec["cls"]).from_pretrained(scale=scale, **kw, device="cpu")
    assert model.device == torch.device("cpu") and model.config == jax_model.config

    carried = copy.deepcopy(model.module)
    load_jax_params(carried, jax_model.variables)
    want = carried.state_dict()
    for key, value in model.module.state_dict().items():
        if key != left_out:  # the parameter the release lacks keeps each package's initial value
            assert torch.equal(value, want[key]), key

    # the reports, through both packages' readers with the release's wrapper
    state = load_torch_state_dict(str(path), key=spec["wrapper"] or "auto")
    report = translate_state_dict(state, copy.deepcopy(model.module), strict=False)
    jax_state = jax_load_torch_state_dict(str(path), key=spec["wrapper"] or "auto")
    _, jax_report = jax_translate_state_dict(jax_state, jax_model.variables, strict=False)
    assert sorted(report.missing) == sorted(_torch_name(k) for k in jax_report.missing) == (
        [left_out] if left_out else [])
    assert sorted(report.unused) == sorted(jax_report.unused) == [UNKNOWN]
    assert sorted(report.dropped) == sorted(jax_report.dropped) and report.dropped == [
        k for k in state if k.endswith(("relative_position_index", "attn_mask", "_SA", "_OCA"))
        or k.startswith(("sub_mean", "add_mean"))]
    assert len(report.matched) == len(jax_report.matched)
    if family == "swinir":  # the missing-parameter warning, as the JAX package prints it
        assert capsys.readouterr().out.count("warning: 1 parameters missing from checkpoint") == 2


def test_strict_release_without_a_parameter_raises(tmp_path, monkeypatch):
    """A strict load (IMDN's) of a release short of a parameter raises,
    naming it, and writes nothing into the module; a misshapen one raises
    too."""
    _offline(monkeypatch)
    path, _ = _write_release("imdn", 2, None, tmp_path)
    state = load_torch_state_dict(str(path))
    model = models.IMDN.build(scale=2, device="cpu")
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    key = sorted(before)[0]
    del state[key]
    with pytest.raises(KeyError, match=key):
        translate_state_dict(state, model.module, strict=True)
    assert all(torch.equal(v, before[k]) for k, v in model.module.state_dict().items())
    state[key] = torch.zeros(1)
    with pytest.raises(ValueError, match=f"shape mismatch for {key}"):
        translate_state_dict(state, model.module)


@pytest.mark.parametrize("family,scale,variant", [("edsr", 4, "DIV2K"), ("rcan", 2, None), ("hat", 4, None)])
def test_missing_file_raises_without_random_weights(tmp_path, monkeypatch, family, scale, variant):
    """No release file and the download patched: ``from_pretrained`` raises
    the download's error; it never serves random weights."""
    _offline(monkeypatch)
    monkeypatch.chdir(tmp_path)
    cls = getattr(models, RELEASES[family]["cls"])
    with pytest.raises(ConnectionError, match="no network"):
        cls.from_pretrained(scale=scale, **_pretrained_kwargs(family, variant), device="cpu")
    with pytest.raises(FileNotFoundError, match="no source"):
        fetch("absent.pth")


def test_explicit_absent_wrapper_key_raises(tmp_path, monkeypatch):
    """A file without the release's wrapper: HAT's ``params_ema`` read names
    the file's top-level keys; ``auto`` takes the file as it is."""
    _offline(monkeypatch)
    path, _ = _write_release("vdsr", 2, None, tmp_path)
    (tmp_path / "pretrained" / "HAT_SRx2.pth").write_bytes(path.read_bytes())
    monkeypatch.chdir(tmp_path)
    with pytest.raises(KeyError, match="no 'params_ema' entry"):
        models.HAT.from_pretrained(scale=2, device="cpu")
    with pytest.raises(KeyError, match="top-level keys"):
        load_torch_state_dict(str(path), key="params")
    assert UNKNOWN in load_torch_state_dict(str(path))
    assert isinstance(translate_state_dict({}, models.VDSR.build(scale=2, device="cpu").module, strict=False),
                      TranslationReport)


@pytest.mark.parametrize("name", ["SRCNN", "ESPCN", "SRResNet"])
def test_families_without_a_release_build(tmp_path, monkeypatch, name):
    _offline(monkeypatch)
    monkeypatch.chdir(tmp_path)
    jax_model = getattr(jax_models, name).from_pretrained(scale=4)
    model = getattr(models, name).from_pretrained(scale=4, device="cpu")
    assert type(model).__name__ == name and model.config == jax_model.config
    assert model.count_parameters() == jax_model.count_parameters()
    assert not (tmp_path / "pretrained").exists()


def test_cli_without_ckpt_serves_the_release_file(tmp_path, monkeypatch):
    """``python -m studiosr_tpu_torch`` without ``--ckpt`` reads
    ``./pretrained``'s SwinIR x4 release offline; its PNG equals the
    in-process ``inference`` output bit for bit."""
    _offline(monkeypatch)
    _write_release("swinir", 4, "DF2K", tmp_path)
    lr = imread(str(FIXTURES / "img0_lrx4.png"))[:16, :20]
    imwrite(str(tmp_path / "lr.png"), lr)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-m", "studiosr_tpu_torch", "--image", "lr.png", "--scale", "4", "--model",
                    "swinir", "--output", "out", "--device", "cpu"], cwd=tmp_path, env=env, check=True, timeout=300,
                   capture_output=True)
    monkeypatch.chdir(tmp_path)
    model = models.SwinIR.from_pretrained(scale=4, device="cpu")
    np.testing.assert_array_equal(imread(str(tmp_path / "out" / "lr.swinir_x4.png")), model.inference(lr))
