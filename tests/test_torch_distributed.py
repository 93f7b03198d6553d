"""A real 2-process ``torch.distributed`` group of the port, on the CPU (gloo).

The port's counterpart of tests/parallel/test_distributed.py and its
dist_worker.py, with the worker in this file: the test starts this file
twice as a script (``python tests/test_torch_distributed.py <rank>
<coordinator> <out dir>``), two processes that join one gloo group on a
free local port, and checks what they report:

* both configuration branches of ``parallel/dist.py``'s ``initialize``: rank
  0 the explicit arguments, rank 1 the ``COORDINATOR_ADDRESS`` /
  ``NUM_PROCESSES`` / ``PROCESS_ID`` environment;
* ``process_count() == 2`` and exactly one main process;
* the two ranks' loader shards of an epoch are disjoint and cover it, and a
  dataset smaller than the world wraps (each rank still gets a sample);
* one data-parallel step of a small SwinIR (f32, no drop-path) on each
  rank's half of a global batch hands Adam the same gradients on both
  ranks, equal to one single-process step's gradients on the whole batch
  within atol 1e-7 and rtol 1e-5 (the all-reduced mean and the whole
  batch's mean sum in other orders), and leaves the same parameters on both
  ranks, equal to the single-process step's within atol 1e-5 and rtol 1e-5
  (Adam's first step divides by |g|, which amplifies the rounding of a
  gradient near zero to at most a few percent of one step of lr 2e-4);
* the ``Trainer`` over the group: both ranks end on the same step with the
  same parameters, and only rank 0 writes its checkpoint and its log;
* a small MaxSR with dropsample (drop-path 0.3) and BatchNorm: the ranks'
  generators, folded with the rank, draw different masks (different
  training-mode outputs on the same input), and the step's gradients and
  BatchNorm running statistics are the mean of what each rank's step
  alone, with its folded generator, gives (atol 1e-7, rtol 1e-5; the
  running statistics are averaged, each shard normalised by its own batch
  statistics).

Each worker has a timeout of its own, so a hung rendezvous fails the test
and not the suite.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(scale=2, embed_dim=16, depths=[2], num_heads=[2], window_size=8, mlp_ratio=2.0, drop_path_rate=0.0)
MAXSR = dict(scale=2, dim=32, dim_head=16, depth=(1, 1), window_size=8, adaptive=False, dropout=0.3)
GLOBAL_BATCH, LR, STEP_SEED = 4, 2e-4, 7


class PairDataset:
    """Seeded in-memory (lq, gt) uint8 pairs, the same on every process."""

    def __init__(self, n: int = 8, size: int = 16, scale: int = 2) -> None:
        self.n, self.size, self.scale = n, size, scale

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        gt = np.random.default_rng(1000 + idx).integers(0, 256, (self.size * self.scale,) * 2 + (3,), dtype=np.uint8)
        return np.ascontiguousarray(gt[:: self.scale, :: self.scale]), gt


def global_batch():
    rng = np.random.default_rng(5)
    lq = rng.random((GLOBAL_BATCH, 16, 16, 3), dtype=np.float32)
    gt = rng.random((GLOBAL_BATCH, 32, 32, 3), dtype=np.float32)
    return torch.from_numpy(lq), torch.from_numpy(gt)


def one_step(module, lq, gt, mesh=None, generator=None):
    """One f32 Adam step of ``module`` on (lq, gt); the loss and the
    gradients the step handed Adam (after the all-reduce, with a mesh)."""
    from studiosr_tpu_torch.parallel.train_step import Adam, make_train_step, prepare_state
    from studiosr_tpu_torch.utils.losses import get_loss

    class RecordingAdam(Adam):
        def update(self, params, grads, state):
            self.grads = {k: g.detach().clone() for k, g in grads.items()}
            return super().update(params, grads, state)

    tx = RecordingAdam(learning_rate=LR)
    state = prepare_state(module, tx)
    step = make_train_step(module, tx, get_loss("l1"), bfloat16=False, mesh=mesh)
    _, loss = step(state, lq, gt, generator)
    return float(loss), tx.grads


def running_stats(module):
    return {k: b.detach().clone() for k, b in module.named_buffers() if k.endswith(("running_mean", "running_var"))}


def digest(module) -> str:
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def worker(mode: str, rank: int, coordinator: str, out_dir: str) -> None:
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from studiosr_tpu_torch.parallel import dist

    def emit(tag, **payload):
        print("DIST:" + json.dumps({"tag": tag, "rank": rank, **payload}), flush=True)

    if mode == "maxsr":
        dist.initialize(coordinator, 2, rank, device="cpu")
        maxsr_worker(rank, out_dir, emit)
    else:
        swinir_worker(rank, coordinator, out_dir, emit)
    dist.shutdown()
    emit("done")


def maxsr_worker(rank: int, out_dir: str, emit) -> None:
    """Each rank: its half of the batch stepped alone with its folded
    generator, and the same step over the group; a training-mode forward of
    the whole batch with its folded generator."""
    import copy

    from studiosr_tpu_torch import MaxSR
    from studiosr_tpu_torch.parallel.mesh import get_mesh
    from studiosr_tpu_torch.parallel.train_step import fold_generator

    model = MaxSR.build(**MAXSR, device="cpu", seed=0)
    lq_all, gt_all = global_batch()
    with torch.no_grad():
        out = model.module.train()(lq_all, generator=fold_generator(torch.Generator().manual_seed(STEP_SEED), rank))
    model.module.eval()
    half = GLOBAL_BATCH // 2
    lq, gt = lq_all[rank * half: (rank + 1) * half], gt_all[rank * half: (rank + 1) * half]
    alone = copy.deepcopy(model.module)
    _, alone_grads = one_step(alone, lq, gt, generator=fold_generator(torch.Generator().manual_seed(STEP_SEED), rank))
    _, grads = one_step(model.module, lq, gt, get_mesh(["cpu"]), torch.Generator().manual_seed(STEP_SEED))
    torch.save({"alone_grads": alone_grads, "alone_stats": running_stats(alone), "grads": grads,
                "stats": running_stats(model.module)}, os.path.join(out_dir, f"maxsr{rank}.pt"))
    emit("maxsr", forward=hashlib.sha256(out.numpy().tobytes()).hexdigest())


def swinir_worker(rank: int, coordinator: str, out_dir: str, emit) -> None:
    from studiosr_tpu_torch import SwinIR, Trainer
    from studiosr_tpu_torch.data import DataHandler, PrefetchLoader
    from studiosr_tpu_torch.parallel import dist
    from studiosr_tpu_torch.parallel.mesh import get_mesh

    if rank == 0:
        dist.initialize(coordinator, 2, 0, device="cpu")
    else:
        os.environ.update(COORDINATOR_ADDRESS=coordinator, NUM_PROCESSES="2", PROCESS_ID=str(rank))
        dist.initialize(device="cpu")
    import torch.distributed as torch_dist

    emit("topology", process_count=dist.process_count(), process_index=dist.process_index(),
         is_main=dist.is_main_process(), backend=torch_dist.get_backend())
    loader = PrefetchLoader(PairDataset(), batch_size=2, rank=rank, world_size=2)
    tiny = PrefetchLoader(PairDataset(n=1), batch_size=2, rank=rank, world_size=2)
    handler = DataHandler(PairDataset(), GLOBAL_BATCH, num_workers=1)
    handler.close()
    emit("shard", indices=loader._epoch_indices(0).tolist(), tiny=tiny._epoch_indices(0).tolist(),
         local_batch=handler.local_batch_size, handler_rank=handler.rank)

    mesh = get_mesh(["cpu"])
    model = SwinIR.build(**SMALL, device="cpu", seed=0)
    half = GLOBAL_BATCH // 2
    lq, gt = (t[rank * half: (rank + 1) * half] for t in global_batch())  # this rank's half of the batch
    loss, grads = one_step(model.module, lq, gt, mesh)
    torch.save({"params": {k: v.detach() for k, v in model.module.state_dict().items()}, "grads": grads},
               os.path.join(out_dir, f"step{rank}.pt"))
    emit("step", loss=loss, digest=digest(model.module), lq_sum=float(lq.sum()))

    ckpt = os.path.join(out_dir, f"ckpt{rank}")
    trainer = Trainer(SwinIR.build(**SMALL, device="cpu", seed=rank), PairDataset(), batch_size=GLOBAL_BATCH,
                      num_workers=1, max_iters=2, eval_interval=2, ckpt_path=ckpt, log_interval=1, seed=3)
    trainer.run()
    emit("trainer", step=trainer.state.step, digest=digest(trainer.model.module), files=sorted(os.listdir(ckpt)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(mode: str, out_dir) -> dict:
    """Both ranks of ``mode`` as subprocesses, 50 s each at most; their
    records by rank and tag."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for stale in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(stale, None)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(rank), coordinator, str(out_dir)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=50)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    records = {0: {}, 1: {}}
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\nSTDOUT:\n{out}\nSTDERR:\n{err[-4000:]}"
        for line in out.splitlines():
            if line.startswith("DIST:"):
                rec = json.loads(line[5:])
                records[rec["rank"]][rec["tag"]] = rec
    for r in (0, 1):
        assert records[r].get("done"), f"rank {r} did not finish: {records[r]}"
    return records


def test_two_process_gloo_group(tmp_path):
    records = run_workers("swinir", tmp_path)
    for r in (0, 1):
        assert records[r]["topology"]["process_count"] == 2 and records[r]["topology"]["process_index"] == r
        assert records[r]["topology"]["backend"] == "gloo"
        assert records[r]["shard"]["local_batch"] == GLOBAL_BATCH // 2 and records[r]["shard"]["handler_rank"] == r
    assert [records[r]["topology"]["is_main"] for r in (0, 1)] == [True, False]

    s0, s1 = (set(records[r]["shard"]["indices"]) for r in (0, 1))
    assert s0 and s1 and not s0 & s1 and s0 | s1 == set(range(8))
    assert records[0]["shard"]["tiny"] == records[1]["shard"]["tiny"] == [0]  # two ranks, one sample: both wrap

    # different halves of the batch, one update: the same parameters on both ranks...
    st0, st1 = records[0]["step"], records[1]["step"]
    assert st0["lq_sum"] != st1["lq_sum"]
    assert st0["digest"] == st1["digest"] and st0["loss"] == st1["loss"]
    # ...and those of one process stepping on the whole batch
    sys.path.insert(0, REPO)
    from studiosr_tpu_torch import SwinIR

    model = SwinIR.build(**SMALL, device="cpu", seed=0)
    want_loss, want_grads = one_step(model.module, *global_batch())
    assert abs(st0["loss"] - want_loss) <= 1e-6 * abs(want_loss)
    got, got1 = (torch.load(tmp_path / f"step{r}.pt", weights_only=True) for r in (0, 1))
    for k, g in want_grads.items():
        assert torch.equal(got["grads"][k], got1["grads"][k]), k
        torch.testing.assert_close(got["grads"][k], g, atol=1e-7, rtol=1e-5, msg=k)
    for k, v in model.module.state_dict().items():
        torch.testing.assert_close(got["params"][k], v, atol=1e-5, rtol=1e-5, msg=k)

    tr0, tr1 = records[0]["trainer"], records[1]["trainer"]
    assert tr0["step"] == tr1["step"] == 2
    assert tr0["digest"] == tr1["digest"]  # rank 1 started from rank 0's weights (its own seed differs)
    assert "latest.model.ckpt" in tr0["files"] and "train.log" in tr0["files"]
    assert tr1["files"] == []  # only the main process writes


def test_two_process_batchnorm_and_drop_path(tmp_path):
    records = run_workers("maxsr", tmp_path)
    # the same input, each rank's folded generator: different dropsample masks
    assert records[0]["maxsr"]["forward"] != records[1]["maxsr"]["forward"]
    r0, r1 = (torch.load(tmp_path / f"maxsr{r}.pt", weights_only=True) for r in (0, 1))
    assert r0["stats"], "MaxSR has BatchNorm running statistics"
    for key in ("grads", "stats"):
        # each rank alone ends elsewhere: its own half of the batch and its own masks
        assert any(not torch.equal(v, r1["alone_" + key][k]) for k, v in r0["alone_" + key].items()), key
        for k, v in r0[key].items():
            assert torch.equal(v, r1[key][k]), (key, k)  # one all-reduce: the same on both ranks
            mean = (r0["alone_" + key][k] + r1["alone_" + key][k]) / 2
            torch.testing.assert_close(v, mean, atol=1e-7, rtol=1e-5, msg=f"{key} {k}")


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
