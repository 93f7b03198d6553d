"""The port's sub-image grids and training corpora against the JAX package's.

On a tiny seeded corpus in the DIV2K / Flickr2K layout (HR 600 x 600 with
its X2 / X3 / X4 LR, 2 x 2 crops in every pack; the originals written with
Paeth rows, so the native unfilter decodes them): the port's
``extract_subimages`` / ``prepare_dataset`` write the JAX package's file
names and the same decoded RGB; ``DIV2K``, ``Flickr2K`` and ``DF2K`` give
its lengths and, sample for sample with the same ``random.Random``, its
arrays exactly. Then the error cases and the per-pack resume.
"""

import os
import random
import shutil

import numpy as np
import pytest
import torch

from studiosr_tpu_torch import data as port_data
from studiosr_tpu_torch import native
from studiosr_tpu_torch.utils import imread
from studiosr_tpu_torch.utils.png import write_png

torch.set_num_threads(2)

PACKS = [("HR", 480, 240), ("X2", 240, 120), ("X3", 160, 80), ("X4", 120, 60)]
HR = 600


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(x / (7 + seed)) * np.cos(y / 11)
    noise = rng.integers(-20, 21, (h, w, 3))
    return np.clip(base[..., None] + noise, 0, 255).astype(np.uint8)


def _write_corpus(root, name, stems, hr_dir, lr_dir):
    """``<root>/<name>/<hr_dir>/<stem>.png`` and ``<lr_dir>/X{s}/<stem>x{s}.png``."""
    for i, stem in enumerate(stems):
        os.makedirs(os.path.join(root, name, hr_dir), exist_ok=True)
        write_png(os.path.join(root, name, hr_dir, f"{stem}.png"), _image(i, HR, HR), row_filter=4)
        for s in (2, 3, 4):
            d = os.path.join(root, name, lr_dir, f"X{s}")
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{stem}x{s}.png"), _image(10 * s + i, HR // s, HR // s), row_filter=4)


def _raw_corpus(root):
    _write_corpus(root, "DIV2K", ["0001", "0002"], "DIV2K_train_HR", "DIV2K_train_LR_bicubic")
    _write_corpus(root, "Flickr2K", ["000001"], "Flickr2K_HR", "Flickr2K_LR_bicubic")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The raw corpus twice: the JAX package prepares one copy, the port the other."""
    base = tmp_path_factory.mktemp("corpora")
    _raw_corpus(str(base / "raw"))
    shutil.copytree(base / "raw", base / "jax")
    shutil.copytree(base / "raw", base / "port")
    return base


def _tree(root):
    return sorted(os.path.relpath(os.path.join(r, f), root) for r, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("pack,crop,step", PACKS)
def test_extract_subimages_matches_the_jax_package(tmp_path, pack, crop, step):
    from studiosr_tpu.data.dataset import extract_subimages as jax_extract

    src = str(tmp_path / "src")
    size = HR if pack == "HR" else HR // int(pack[1])
    for i in range(2):
        os.makedirs(src, exist_ok=True)
        write_png(os.path.join(src, f"{i:04d}" + ("" if pack == "HR" else pack.lower()) + ".png"),
                  _image(i, size, size), row_filter=4)
    native.reset_counters()
    port_data.extract_subimages(src, str(tmp_path / "port"), crop, step)
    assert native.counters()["unfilter"].get("python", 0) == 0
    jax_extract(src, str(tmp_path / "jax"), crop, step)
    names = _tree(tmp_path / "port")
    assert names == _tree(tmp_path / "jax")
    assert len(names) == 2 * 4 and names[0] == "0000_001.png"  # 2 x 2 crops, the last one snapped to the edge
    for name in names:
        np.testing.assert_array_equal(imread(str(tmp_path / "port" / name)), imread(str(tmp_path / "jax" / name)))
    assert not os.path.exists(str(tmp_path / "port") + ".partial")


def test_nested_names_flatten_and_strip_only_a_trailing_scale_tag(tmp_path):
    from studiosr_tpu.data.dataset import extract_subimages as jax_extract

    src = tmp_path / "src"
    (src / "deep" / "er").mkdir(parents=True)
    for rel in ("deep/er/0007x4.png", "ax4b.png", "x3.png"):
        write_png(str(src / rel), _image(len(rel), 130, 125))
    port_data.extract_subimages(str(src), str(tmp_path / "port"), 120, 60)
    jax_extract(str(src), str(tmp_path / "jax"), 120, 60)
    names = _tree(tmp_path / "port")
    assert names == _tree(tmp_path / "jax")
    assert "deep_er_0007_001.png" in names and "ax4b_004.png" in names and "_001.png" in names


def test_prepare_dataset_builds_the_jax_packages_packs(corpora):
    from studiosr_tpu.data.dataset import prepare_dataset as jax_prepare

    port_data.prepare_dataset(str(corpora / "port"), "DIV2K", "_train")
    jax_prepare(str(corpora / "jax"), "DIV2K", "_train")
    sub = os.path.join("DIV2K", "sub")
    names = _tree(corpora / "port" / sub)
    assert names == _tree(corpora / "jax" / sub)
    for pack in ("DIV2K_train_HR", *(f"DIV2K_train_LR_bicubic/X{s}" for s in (2, 3, 4))):
        assert sum(n.startswith(pack + os.sep) for n in names) == 2 * 4
    for name in names[::3]:
        np.testing.assert_array_equal(imread(str(corpora / "port" / sub / name)),
                                      imread(str(corpora / "jax" / sub / name)))


@pytest.mark.parametrize("name", ["DIV2K", "Flickr2K", "DF2K"])
def test_corpus_classes_give_the_jax_packages_samples(corpora, name, monkeypatch):
    """len, and get(i, rng) with transform and to_tensor (the port on its
    native route, the JAX package on its numpy one) and without, exactly."""
    import studiosr_tpu.data as jax_data
    from studiosr_tpu import native as jax_native

    monkeypatch.setattr(jax_native, "native_available", lambda: False)
    for transform in (True, False):
        port = getattr(port_data, name)(str(corpora / "port"), size=24, scale=4, transform=transform,
                                        to_tensor=transform)
        ref = getattr(jax_data, name)(str(corpora / "jax"), size=24, scale=4, transform=transform,
                                      to_tensor=transform)
        assert len(port) == len(ref) == (12 if name == "DF2K" else 8 if name == "DIV2K" else 4)
        native.reset_counters()
        for i in range(len(port)):
            for seed in (0, 1):
                got = port.get(i, rng=random.Random(f"{seed}:{i}"))
                want = ref.get(i, rng=random.Random(f"{seed}:{i}"))
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    np.testing.assert_array_equal(g, w)
        if transform:
            assert native.counters()["crop_augment"] == {"native": 2 * len(port)}


def test_extract_subimages_errors(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no images"):
        port_data.extract_subimages(str(empty), str(tmp_path / "out"), 120, 60)
    small = tmp_path / "small"
    small.mkdir()
    write_png(str(small / "a.png"), _image(0, 100, 140))
    with pytest.raises(ValueError, match="100x140, smaller than crop_size 120"):
        port_data.extract_subimages(str(small), str(tmp_path / "out"), 120, 60)
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "a.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    with pytest.raises(ValueError, match="unreadable image in dataset"):
        port_data.extract_subimages(str(broken), str(tmp_path / "out"), 120, 60)
    assert not (tmp_path / "out").exists()


def test_a_stale_partial_pack_is_rebuilt(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    write_png(str(src / "0001.png"), _image(0, 150, 150))
    partial = tmp_path / "out.partial"
    partial.mkdir()
    (partial / "stale_001.png").write_bytes(b"left by an interrupted run")
    port_data.extract_subimages(str(src), str(tmp_path / "out"), 120, 60)
    assert _tree(tmp_path / "out") == [f"0001_{i:03d}.png" for i in range(1, 5)]
    assert not partial.exists()


def test_corpus_resumes_a_missing_pack(tmp_path, capsys):
    _write_corpus(str(tmp_path), "DIV2K", ["0001"], "DIV2K_train_HR", "DIV2K_train_LR_bicubic")
    port_data.DIV2K(str(tmp_path), scale=4)
    x3 = tmp_path / "DIV2K" / "sub" / "DIV2K_train_LR_bicubic" / "X3"
    shutil.rmtree(x3)
    capsys.readouterr()
    ds = port_data.DIV2K(str(tmp_path), scale=4)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and "X3" in printed[0]  # only the missing pack, one line
    assert len(ds) == 4 and len(_tree(x3)) == 4
