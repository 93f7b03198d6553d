"""The port's checkpoint reader and ``load_model`` vs the JAX package.

The reader (``zoo/checkpoint.py``, no flax or msgpack) must restore the
same tree as ``flax.serialization.msgpack_restore``, bitwise; ``load_model``
must rebuild the trained fixtures (``tests/fixtures/quality/*_ckpt``, written
by the JAX Trainer) so that they serve like the JAX package's
``load_model(...).inference``: uint8 outputs within 1 LSB on under 1 % of
pixels. A port-Trainer checkpoint (``torch.save``) loads through the same
function.
"""

import glob
import json
import os
import shutil

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from studiosr_tpu.utils.helpers import imread as jax_imread
from studiosr_tpu.zoo.registry import load_model as jax_load_model
from studiosr_tpu_torch import SwinIR, Trainer
from studiosr_tpu_torch.parallel import prepare_state
from studiosr_tpu_torch.zoo import load_model, msgpack_restore

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "quality")
CKPTS = sorted(glob.glob(os.path.join(FIXTURES, "*", "best.model.ckpt")))
TRAINED = [("swinir_ckpt", "swinir", 4), ("swinir_x2_ckpt", "swinir", 2), ("swinir_x3_ckpt", "swinir", 3),
           ("swinir_x8_ckpt", "swinir", 8), ("hat_ckpt", "hat", 4), ("hat_x2_ckpt", "hat", 2), ("hat_x3_ckpt", "hat", 3)]


def _assert_same_tree(want, got, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_reader_equals_flax_msgpack_restore(path):
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_tree(serialization.msgpack_restore(data), msgpack_restore(data))


def test_reader_chunked_records_and_scalars(monkeypatch):
    """Leaves over flax's chunk limit (lowered here to 256 bytes) become
    chunked-array records; numpy scalars, complex numbers, ints of every
    width, floats, nil, bool, str and bin come back as flax reads them."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(0)
    tree = {
        "big": rng.standard_normal((9, 17)).astype(np.float32),
        "ints": np.arange(300, dtype=np.int64).reshape(3, 100),
        "small": {"a": rng.standard_normal(5).astype(np.float16), "scalar": np.float32(1.5)},
        "values": {"c": 1.0 + 2.0j, "i": [0, -1, 127, -33, 255, 70000, -70000, 2**40, -(2**40)], "f": 0.25,
                   "none": None, "t": True, "s": "x" * 40, "b": b"\x00\x01"},
    }
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(serialization.msgpack_restore(data), msgpack_restore(data))


def test_reader_widens_bfloat16_exactly():
    x = np.asarray(jax.numpy.asarray([1.5, -2.0, 3.140625], jax.numpy.bfloat16))
    got = msgpack_restore(serialization.msgpack_serialize({"w": x}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.astype(np.float32))


@pytest.mark.parametrize(
    "data,match",
    [
        (msgpack.packb({"w": msgpack.ExtType(7, b"ab")}), "ext type 7 at byte 3"),
        (msgpack.packb({"w": 1})[:-1], "ends"),
        (msgpack.packb([1]) + b"\x00", "continues past"),
        (b"\xc1", "0xc1 at byte 0"),
    ],
    ids=["unknown-ext", "truncated", "trailing", "reserved-byte"],
)
def test_reader_rejects_what_flax_does_not_write(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack_restore(data)


def _pairs(scale, mod_crop):
    pairs = []
    for i in range(3):
        hr = jax_imread(os.path.join(FIXTURES, f"img{i}_hr.png"))
        hr = hr[: hr.shape[0] // mod_crop * mod_crop, : hr.shape[1] // mod_crop * mod_crop]
        pairs.append((jax_imread(os.path.join(FIXTURES, f"img{i}_lrx{scale}.png")), hr))
    return pairs


@pytest.mark.parametrize("subdir,name,scale", TRAINED, ids=[t[0] for t in TRAINED])
def test_trained_fixture_serves_like_the_jax_package(subdir, name, scale):
    ckpt = os.path.join(FIXTURES, subdir)
    jax_model = jax_load_model(ckpt, name)
    model = load_model(ckpt, name, device="cpu")
    assert model.config == jax_model.config
    lr, _ = _pairs(scale, scale)[0]
    want = jax_model.inference(lr)
    got = model.inference(lr)
    assert got.shape == want.shape == (lr.shape[0] * scale, lr.shape[1] * scale, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _tmp_copy(tmp_path, subdir):
    dst = tmp_path / subdir
    shutil.copytree(os.path.join(FIXTURES, subdir), dst)
    return dst


def test_ema_weights_of_a_jax_checkpoint(tmp_path):
    """``ema=True`` serves ``{tag}.ema.ckpt`` (a flax params tree): the port
    holds the JAX package's EMA weights, not the raw ones."""
    ckpt = _tmp_copy(tmp_path, "swinir_x2_ckpt")
    jax_model = jax_load_model(str(ckpt), "swinir")
    ema = jax.tree_util.tree_map(lambda p: np.asarray(p) * 0.5, jax_model.variables["params"])
    (ckpt / "best.ema.ckpt").write_bytes(serialization.to_bytes(ema))
    jax_ema = jax_load_model(str(ckpt), "swinir", ema=True)
    model = load_model(str(ckpt), "swinir", ema=True, device="cpu")
    lr = _pairs(2, 2)[0][0]
    want, got = jax_ema.inference(lr), model.inference(lr)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    raw = load_model(str(ckpt), "swinir", device="cpu")
    assert torch.equal(model.module.conv_first.weight, raw.module.conv_first.weight * 0.5)


def test_port_trainer_checkpoint_loads_through_load_model(tmp_path):
    """``Trainer.save`` writes ``torch.save`` files; ``load_model`` tells them
    from flax bytes by their leading bytes, for the weights and the EMA."""
    config = dict(scale=2, embed_dim=16, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0)
    model = SwinIR.build(**config, seed=3, device="cpu")
    trainer = Trainer(model, None, ckpt_path=str(tmp_path / "run"), ema_decay=0.999, bfloat16=False)
    trainer.state = prepare_state(model.module, trainer.tx, ema_decay=0.999)
    with torch.no_grad():
        for v in trainer.state.ema_params.values():
            v.mul_(0.5)
    trainer.save("best")
    loaded = load_model(str(tmp_path / "run"), "swinir", device="cpu")
    for key, value in model.module.state_dict().items():
        assert torch.equal(loaded.module.state_dict()[key], value), key
    ema = load_model(str(tmp_path / "run"), "swinir", ema=True, device="cpu")
    for key, value in model.module.named_parameters():
        assert torch.equal(dict(ema.module.named_parameters())[key], value * 0.5), key
    image = np.random.default_rng(0).integers(0, 256, (12, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(loaded.inference(image), model.inference(image))


@pytest.mark.parametrize("edit,match", [({"mlp_ratio": 4.0}, "shape mismatch at"), ({"depths": [2, 2, 2]},
                                                                                     "keys differ")])
def test_edited_params_json_raises_naming_the_file(tmp_path, edit, match):
    ckpt = _tmp_copy(tmp_path, "swinir_ckpt")
    config = json.loads((ckpt / "params.json").read_text())
    if "depths" in edit:
        edit = dict(edit, num_heads=[2, 2, 2])
    (ckpt / "params.json").write_text(json.dumps({**config, **edit}))
    with pytest.raises(ValueError, match=match) as info:
        load_model(str(ckpt), "swinir", device="cpu")
    assert str(ckpt / "best.model.ckpt") in str(info.value)


def test_models_not_ported_raise_naming_their_item():
    """The conv families, SwinFIR and MaxSR, which raised naming A16, A14
    and A15 until they were ported, load; an unknown name still raises."""
    assert type(load_model(os.path.join(FIXTURES, "ckpt"), "espcn", device="cpu")).__name__ == "ESPCN"
    assert type(load_model(os.path.join(FIXTURES, "srresnet_ckpt"), "srresnet", device="cpu")).__name__ == "SRResNet"
    assert type(load_model(os.path.join(FIXTURES, "maxsr_ckpt"), "maxsr", device="cpu")).__name__ == "MaxSR"
    with pytest.raises(KeyError, match="available"):
        load_model(os.path.join(FIXTURES, "swinir_ckpt"), "swinirr", device="cpu")
