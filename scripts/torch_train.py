"""Training entry point of the PyTorch / CUDA port.

    python3 scripts/torch_train.py --model swinir --scale 4 --data-dir dataset \
        --dataset DIV2K --eval-dataset DIV2K_mini

The port's counterpart of ``scripts/train.py``, with the same flags in the
same order and ``--device`` (``cuda`` by default; ``cpu`` trains in f32
with the plain kernel versions). Builds the model fresh, applies its
published training recipe (``get_training_config``; ``--max-iters`` and
``--batch-size`` override it), prepares the corpus's sub-image grids on
first use, and evaluates and checkpoints every ``eval_interval``
iterations. The evaluation set is read from ``<data-dir>/<eval-dataset>``.
Resume is automatic from ``<ckpt>/latest``. ``--multihost`` joins a
process group first (``studiosr_tpu_torch.parallel.dist.initialize``, from
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``; NCCL on
``cuda``, gloo on ``cpu``): one process a card, each on its shard of the
global batch, rank 0 alone logging, evaluating and checkpointing. For two
cards of one host:

    COORDINATOR_ADDRESS=localhost:29500 NUM_PROCESSES=2 PROCESS_ID=0 \
        python3 scripts/torch_train.py --multihost ... &
    COORDINATOR_ADDRESS=localhost:29500 NUM_PROCESSES=2 PROCESS_ID=1 \
        python3 scripts/torch_train.py --multihost ...

``main(argv)`` runs it in process and returns the ``Trainer``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="StudioSR trainer (PyTorch / CUDA)")
    parser.add_argument("--model", type=str, default="swinir")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--dataset", type=str, default="DIV2K", choices=["DIV2K", "Flickr2K", "DF2K"])
    parser.add_argument("--data-dir", type=str, default="dataset")
    parser.add_argument("--download", action="store_true", help="download the training corpus on first use")
    parser.add_argument("--eval-dataset", type=str, default="DIV2K_mini")
    parser.add_argument("--size", type=int, default=64, help="LR crop size")
    parser.add_argument("--ckpt", type=str, default="checkpoints")
    parser.add_argument("--max-iters", type=int, default=None, help="override the recipe's max_iters")
    parser.add_argument("--batch-size", type=int, default=None, help="override the recipe's batch")
    parser.add_argument("--eval-interval", type=int, default=1000)
    parser.add_argument("--profile-dir", type=str, default=None, help="write a torch.profiler Chrome trace here")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="maintain EMA weights ({tag}.ema.ckpt; serve with load_model(ema=True))")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="micro-steps accumulated per optimizer update (effective batch = k x batch)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-process data parallelism (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.multihost:
        import torch.distributed

        from studiosr_tpu_torch.parallel import dist

        dist.initialize(device=args.device)
        if dist.is_initialized():
            print(f"process group: rank {dist.process_index()} of {dist.process_count()}, backend "
                  f"{torch.distributed.get_backend()}")
    try:
        return _train(args)
    finally:
        if args.multihost:
            dist.shutdown()


def _train(args):

    import studiosr_tpu_torch.data as data
    from studiosr_tpu_torch.engine import Evaluator, Trainer
    from studiosr_tpu_torch.zoo.registry import get_model_class

    model = get_model_class(args.model).build(scale=args.scale, device=args.device)
    recipe = model.get_training_config()
    if args.max_iters is not None:
        recipe["max_iters"] = args.max_iters
    if args.batch_size is not None:
        recipe["batch_size"] = args.batch_size

    dataset_cls = {"DIV2K": data.DIV2K, "Flickr2K": data.Flickr2K, "DF2K": data.DF2K}[args.dataset]
    dataset = dataset_cls(
        args.data_dir, size=args.size, scale=args.scale, transform=True, to_tensor=True, download=args.download
    )
    evaluator = Evaluator(args.eval_dataset, scale=args.scale, root=args.data_dir)

    trainer = Trainer(
        model,
        dataset,
        evaluator,
        eval_interval=args.eval_interval,
        ckpt_path=args.ckpt,
        profile_dir=args.profile_dir,
        ema_decay=args.ema_decay,
        grad_accum_steps=args.grad_accum,
        **recipe,
    )
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
