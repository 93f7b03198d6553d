"""CLI upscaler: ``python -m studiosr_tpu_torch --image --scale --model --output``.

Port of ``studiosr_tpu/__main__.py``, with the same flags plus ``--device``
(default ``cuda``, as every entry point of the port; ``--device cpu`` runs
the plain path on the CPU). ``--ckpt`` serves a trained checkpoint directory
(``params.json`` + ``{tag}.model.ckpt``, written by the JAX package's Trainer
or the port's) and works offline. Without ``--ckpt`` the CLI serves the
published weights through ``from_pretrained``: the release file under
``./pretrained`` (``001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth``,
``HAT_SRx4.pth``, ...), offline when it is there, downloaded there first when
it is not. ``--half`` serves in bf16 through the fused CUDA
kernels; ``--tile`` serves overlapping tiles; ``--self-ensemble`` averages
the 8 rot90 / flip variants; ``--batch`` groups same-shaped images into one
forward. PNG is read and written without cv2.
"""

from __future__ import annotations

import argparse
import os


def _walk_image_paths(root: str, skip_dir: str) -> list:
    """Sorted full paths of images under ``root``, excluding ``skip_dir``."""
    from studiosr_tpu_torch.utils.helpers import get_image_extensions

    exts = set(get_image_extensions())
    skip = os.path.abspath(skip_dir)
    paths = []
    for r, _dirs, files in os.walk(root):
        ar = os.path.abspath(r)
        if ar == skip or ar.startswith(skip + os.sep):
            continue
        paths.extend(os.path.join(r, f) for f in files if os.path.splitext(f)[1].lower() in exts)
    return sorted(paths)


def main() -> None:
    from studiosr_tpu_torch.utils import imread, imwrite
    from studiosr_tpu_torch.zoo.registry import MODEL_REGISTRY, get_model_class, load_model

    parser = argparse.ArgumentParser(description="StudioSR (PyTorch / CUDA)")
    parser.add_argument("--image", type=str, default="./", help="image or directory to be upscaled")
    parser.add_argument("--scale", type=int, default=4, help="upscaling factor -> [2, 3, 4]")
    parser.add_argument("--model", type=str, default="swinir", help=f"model name -> {sorted(MODEL_REGISTRY)}")
    parser.add_argument("--output", type=str, default="./studiosr", help="output directory")
    parser.add_argument("--tile", type=int, default=0, help="tile size for tiled inference (0 = whole image)")
    parser.add_argument("--tile-overlap", type=int, default=16, help="tile halo in LR pixels")
    parser.add_argument("--self-ensemble", action="store_true", help="8-way rot/flip test-time ensemble")
    parser.add_argument(
        "--ckpt", type=str, default="",
        help="serve a trained checkpoint directory ({best,latest}.model.ckpt + params.json) instead of the "
             "pretrained zoo; works offline",
    )
    parser.add_argument("--ckpt-tag", type=str, default="best", help="checkpoint tag with --ckpt (best/latest)")
    parser.add_argument("--half", action="store_true", help="bf16 through the fused CUDA kernels")
    parser.add_argument(
        "--batch", type=int, default=1, help="batch same-shaped images through one forward (whole-image mode only)"
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()

    path = args.image
    # Full-path recursive walk, skipping anything under the output directory.
    paths = [path] if os.path.isfile(path) else _walk_image_paths(path, skip_dir=args.output)
    root = path if os.path.isdir(path) else os.path.dirname(path)
    if args.ckpt:
        model = load_model(args.ckpt, args.model, tag=args.ckpt_tag, device=args.device)
        if model.scale != args.scale:
            parser.error(f"--scale {args.scale} but checkpoint is x{model.scale} ({args.ckpt})")
    else:
        model = get_model_class(args.model).from_pretrained(scale=args.scale, device=args.device)
    if args.half:
        model.half()
        if hasattr(model, "enable_fused"):
            model.enable_fused(True)

    os.makedirs(args.output, exist_ok=True)

    def save(file_path, out):
        # Root-relative name with separators flattened: inputs that share a
        # basename in different subdirectories must not overwrite each other.
        rel = os.path.relpath(file_path, root) if root else os.path.basename(file_path)
        name = os.path.splitext(rel)[0].replace(os.sep, "__")
        save_path = os.path.join(args.output, f"{name}.{args.model}_x{args.scale}.png")
        imwrite(save_path, out)
        print(" -> ", save_path)

    if args.batch > 1 and not (args.tile or args.self_ensemble):
        # Group same-shaped images; shapes are probed first and pixels
        # re-read per chunk, so memory stays O(batch).
        by_shape: dict = {}
        for file_name in paths:
            by_shape.setdefault(imread(file_name).shape, []).append(file_name)
        for names in by_shape.values():
            for i in range(0, len(names), args.batch):
                chunk = names[i : i + args.batch]
                for n, out in zip(chunk, model.inference_batch([imread(n) for n in chunk])):
                    save(n, out)
        return

    for file_name in paths:
        image = imread(file_name)
        if args.tile:
            out = model.inference_tiled(image, tile=args.tile, tile_overlap=args.tile_overlap)
        elif args.self_ensemble:
            out = model.inference_with_self_ensemble(image)
        else:
            out = model.inference(image)
        save(file_name, out)


if __name__ == "__main__":
    main()
