"""Serving over a mesh of several slots in one process (``parallel/mesh.py``):
``tiled_inference(mesh=)`` in both loops, ``evaluate_uint8_batch(mesh=)``,
``Model.manual_forward_uint8`` and ``Model.sharded_forward``, against the
port's own mesh-less routes and the JAX package's mesh routes on the 8
virtual CPU devices of ``tests/conftest.py``; then the launch helper every
C entry goes through (``ops/cuda/_launch.py`` ``call``) and the launch
counters under several host threads.

Models: the trained ESPCN x2, SwinIR x2 and HAT x2 fixtures
(``tests/fixtures/quality``), the port's SwinIR and HAT served fused (the
kernels' plain versions on the CPU). A slot here is a CPU device named
more than once: each holds its own replica and runs on its own thread.

Tolerances: against the port's mesh-less output, bit for bit; uint8 images
against the JAX package within 1 LSB on under 1 % of pixels; scores within
1e-4 dB PSNR and 1e-5 SSIM.
"""

import ast
import functools
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from studiosr_tpu.parallel.mesh import get_mesh as jax_get_mesh
from studiosr_tpu.parallel.tiled import tiled_inference as jax_tiled_inference
from studiosr_tpu.zoo.registry import load_model as jax_load_model
from studiosr_tpu_torch import load_model
from studiosr_tpu_torch.ops.cuda import _launch, engagement
from studiosr_tpu_torch.parallel import get_mesh, tiled_inference
from studiosr_tpu_torch.parallel.mesh import Mesh, replicas, run_sharded
from studiosr_tpu_torch.utils import imread

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "quality"
# family -> (checkpoint, LR suffix, served fused by the port)
MODELS = {"espcn": ("ckpt", "_lr", False), "swinir": ("swinir_x2_ckpt", "_lrx2", True),
          "hat": ("hat_x2_ckpt", "_lrx2", True)}
TILED = dict(tile=32, tile_overlap=8, tile_batch=4)


def _close_uint8(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@functools.lru_cache(maxsize=None)
def _pair(family: str):
    ckpt, suffix, fused = MODELS[family]
    path = str(FIXTURES / ckpt)
    model = load_model(path, family, device="cpu")
    if fused:
        model.enable_fused(True)
    return jax_load_model(path, family), model, suffix


def _image(suffix: str) -> np.ndarray:
    """48 x 40 LR from the first fixture: 2 x 2 tiles of 32, overlap 8."""
    return np.ascontiguousarray(imread(str(FIXTURES / f"img0{suffix}.png"))[:48, :40])


@functools.lru_cache(maxsize=None)
def _jax_tiled(family: str, device_loop: bool) -> np.ndarray:
    jax_model, _, suffix = _pair(family)
    return jax_tiled_inference(jax_model, _image(suffix), mesh=jax_get_mesh(), device_loop=device_loop, **TILED)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host_loop", "device_loop"])
@pytest.mark.parametrize("family", list(MODELS))
def test_tiled_over_a_mesh_matches_the_meshless_bytes_and_jax(family, device_loop):
    """Both loops over 2 and 4 CPU slots: the mesh-less bytes, and the JAX
    package's loop over its 8-device mesh within the uint8 rule."""
    _, model, suffix = _pair(family)
    image = _image(suffix)
    want = tiled_inference(model, image, device_loop=device_loop, **TILED)
    for slots in (2, 4):
        got = tiled_inference(model, image, mesh=get_mesh(["cpu"] * slots), device_loop=device_loop, **TILED)
        np.testing.assert_array_equal(got, want)
    assert want.shape == (96, 80, 3)
    _close_uint8(want, _jax_tiled(family, device_loop))


def _eval_batch():
    """The three x2 fixture pairs and the first again: 4 images."""
    pairs = [(imread(str(FIXTURES / f"img{i}_lrx2.png")), imread(str(FIXTURES / f"img{i}_hr.png")))
             for i in (0, 1, 2, 0)]
    return tuple(np.stack([p[j] for p in pairs]) for j in (0, 1))


@pytest.mark.parametrize("slots", [2, 4])
def test_evaluate_uint8_batch_over_a_mesh_matches_jax(slots):
    """Each slot scores its share; the (B, 2) scores are the mesh-less
    ones exactly and the JAX package's over a mesh of as many devices."""
    jax_model, model, _ = _pair("swinir")
    lqs, gts = _eval_batch()
    got = model.evaluate_uint8_batch(lqs, gts, crop_border=2, mesh=get_mesh(["cpu"] * slots))
    plain = model.evaluate_uint8_batch(lqs, gts, crop_border=2)
    want = jax_model.evaluate_uint8_batch(lqs, gts, crop_border=2, mesh=jax_get_mesh(jax.devices()[:slots]))
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)


def test_evaluate_uint8_batch_raises_unless_the_batch_divides():
    jax_model, model, _ = _pair("swinir")
    lqs, gts = _eval_batch()
    for m in (get_mesh(["cpu"] * 3), jax_get_mesh(jax.devices()[:3])):
        with pytest.raises(ValueError, match="does not divide"):
            (model if isinstance(m, Mesh) else jax_model).evaluate_uint8_batch(lqs, gts, mesh=m)
    with pytest.raises(ValueError, match="does not divide"):
        model.manual_forward_uint8(torch.from_numpy(lqs[:3]), get_mesh(["cpu", "cpu"]))


@pytest.mark.parametrize("family", ["swinir", "hat"])
def test_manual_forward_uint8_and_sharded_forward_give_the_meshless_outputs(family):
    """Over 2 and 4 slots each slot runs the single-card forward on its
    share: the float output is the mesh-less forwards of the shares bit for
    bit, and of the whole batch where the shares hold more than one image
    (HAT serves a single image through its own route, the CAB join folded
    into B6); the uint8 output is the mesh-less whole batch's bit for bit
    and the JAX package's ``manual_forward_uint8`` over 4 devices within
    the uint8 rule; ``sharded_forward`` without a mesh is the plain
    forward."""
    jax_model, model, suffix = _pair(family)
    x = torch.from_numpy(np.stack([_image(suffix)[:16, :16], _image(suffix)[16:32, 8:24]] * 2))
    xf = x.float() / 255
    want_u8, want_f = model.forward_uint8(x), model(xf)
    for slots in (2, 4):
        mesh = get_mesh(["cpu"] * slots)
        assert torch.equal(model.manual_forward_uint8(x, mesh), want_u8)
        got = model.sharded_forward(xf, mesh)
        assert torch.equal(got, torch.cat([model(share) for share in xf.split(len(x) // slots)]))
        if slots == 2 or family == "swinir":
            assert torch.equal(got, want_f)
    assert torch.equal(model.sharded_forward(xf), want_f)
    jax_u8 = np.asarray(jax_model.manual_forward_uint8(x.numpy(), jax_get_mesh(jax.devices()[:4])))
    _close_uint8(want_u8.numpy(), jax_u8)


def test_replicas_one_a_slot():
    """The first slot on the model's device is the model itself, the others
    copies with the same weights bit for bit and their own serving prep;
    cached, and dropped by ``enable_fused``, ``half``, ``astype`` and ``to``;
    a device that is neither cpu nor cuda raises."""
    model = load_model(str(FIXTURES / "swinir_x2_ckpt"), "swinir", device="cpu").enable_fused(True)
    mesh = get_mesh(["cpu"] * 3)
    reps = replicas(model, mesh)
    assert reps[0] is model and len({id(r) for r in reps}) == 3
    want = model.module.state_dict()
    for r in reps[1:]:
        got = r.module.state_dict()
        assert all(torch.equal(got[k], v) and got[k].data_ptr() != v.data_ptr() for k, v in want.items())
    x = torch.zeros((3, 16, 16, 3), dtype=torch.uint8)
    run_sharded(model, mesh, lambda r, share: r.forward_uint8(share), x)
    assert all(r.__dict__.get("_serving_prep_cache") is not None for r in reps)
    assert replicas(model, mesh) == reps
    for drop in (lambda m: m.enable_fused(True), lambda m: m.half(), lambda m: m.astype(torch.float32),
                 lambda m: m.to("cpu")):
        replicas(model, mesh)
        drop(model)
        assert "_replica_cache" not in model.__dict__
    with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
        replicas(model, get_mesh(["cpu", "meta"]))


def test_get_mesh_takes_every_card(monkeypatch):
    """Without a process group ``get_mesh()`` holds every visible card, as
    the JAX package's holds every local device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = get_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(3)) and mesh.size == 3
    assert get_mesh(["cpu", "cpu"]).size == 2


# -- a mesh over several processes: tiled serving raises, as in the JAX package ----------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tiled_over_several_processes_raises():
    """Two gloo processes (the harness of ``tests/test_torch_distributed.py``):
    ``get_mesh()`` in a group is the rank's own device over a world of 2,
    and ``tiled_inference`` over it raises in both loops, while
    ``evaluate_uint8_batch`` scores the rank's own images."""
    path = os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    for stale in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(stale, None)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), coordinator], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append((p.returncode, *p.communicate(timeout=50)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}\n{err[-4000:]}"
        rec = json.loads([line for line in out.splitlines() if line.startswith("MESH:")][-1][5:])
        assert rec == {"devices": ["cpu"], "world": 2, "size": 2, "raised": [True, True], "scored": 2}, rec


def _worker(rank: int, coordinator: str) -> None:
    from studiosr_tpu_torch import ESPCN
    from studiosr_tpu_torch.parallel import dist

    dist.initialize(coordinator, 2, rank, device="cpu")
    mesh = get_mesh()
    model = ESPCN.build(scale=2, device="cpu", seed=0)
    image = np.zeros((24, 24, 3), np.uint8)
    raised = []
    for loop in (False, True):
        try:
            tiled_inference(model, image, tile=16, tile_overlap=4, mesh=mesh, device_loop=loop)
            raised.append(False)
        except ValueError as e:
            raised.append("several processes" in str(e))
    psnr, _ = model.evaluate_uint8_batch(np.zeros((2, 8, 8, 3), np.uint8), np.zeros((2, 16, 16, 3), np.uint8),
                                         mesh=mesh)
    dist.shutdown()
    print("MESH:" + json.dumps({"devices": [str(d) for d in mesh.devices], "world": mesh.world_size,
                                "size": mesh.size, "raised": raised, "scored": len(psnr)}), flush=True)


# -- the launch helper and the counters -------------------------------------------------


def _c_calls_outside_the_helper(path: Path) -> list:
    """Calls of a kernel library's C function (``lib.<entry>(...)`` or
    ``getattr(lib, ...)(...)``) made other than through ``call``, and any
    read of a stream handle outside ``_launch.py``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            direct = isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and f.value.id == "lib"
            fetched = (isinstance(f, ast.Call) and isinstance(f.func, ast.Name) and f.func.id == "getattr"
                       and isinstance(f.args[0], ast.Name) and f.args[0].id == "lib")
            if direct or fetched:
                bad.append(f"{path.name}:{node.lineno} calls a C entry directly")
        if isinstance(node, ast.Attribute) and node.attr in ("cuda_stream", "current_stream"):
            bad.append(f"{path.name}:{node.lineno} reads {node.attr}")
    return bad


WRAPPER_FILES = sorted(p for p in (REPO / "studiosr_tpu_torch" / "ops" / "cuda").glob("*.py")
                       if p.name not in ("_launch.py", "_build.py", "__init__.py", "engagement.py"))


def test_every_c_entry_goes_through_the_launch_helper(tmp_path):
    """No wrapper under ``ops/cuda/`` calls a C entry or reads a stream
    itself: ``_launch.call`` makes the operands' card current around every
    call (C10). Every module that loads a library calls through it."""
    assert len(WRAPPER_FILES) >= 10
    bad = [b for path in WRAPPER_FILES for b in _c_calls_outside_the_helper(path)]
    assert not bad, bad
    for path in WRAPPER_FILES:
        text = path.read_text()
        if "_build.load(" in text:
            assert "call(dev, " in text and "STREAM" in text, path.name
    # the scan sees a direct call when there is one
    probe = tmp_path / "probe.py"
    probe.write_text("def f(lib, dev):\n    return lib.entry(1, dev)\n")
    assert _c_calls_outside_the_helper(probe) == ["probe.py:2 calls a C entry directly"]


def test_call_makes_the_device_current_and_passes_its_stream(monkeypatch):
    """``call`` enters ``torch.cuda.device(device)`` around the C call,
    puts the device's current stream where ``STREAM`` stands and leaves
    the previous device current afterwards."""
    current = ["cuda:0"]

    class Device:
        def __init__(self, device):
            self.device = str(device)

        def __enter__(self):
            self.prev, current[0] = current[0], self.device

        def __exit__(self, *exc):
            current[0] = self.prev

    class Stream:
        def __init__(self, device):
            self.cuda_stream = 1000 + torch.device(device).index

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    seen = []
    status = _launch.call(torch.device("cuda:1"), lambda *a: seen.append((current[0], a)) or 0, 7, None,
                          _launch.STREAM)
    assert status == 0 and seen == [("cuda:1", (7, None, 1001))] and current == ["cuda:0"]


def test_launch_counters_under_threads():
    """More threads than cores counting at once, the interpreter switching
    threads often, lose no launch."""
    workers, each = (os.cpu_count() or 4) + 4, 2000
    engagement.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [engagement.launched("k", f"e{i % 2}") for i in range(each)])
                   for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert engagement.counters() == {"k": workers * each}
    assert engagement.entries() == {"k": {"e0": workers * each // 2, "e1": workers * each // 2}}
    engagement.reset()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
