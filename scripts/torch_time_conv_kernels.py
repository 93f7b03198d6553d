#!/usr/bin/env python3
"""Time the port's convolution kernels and B1 on one NVIDIA GPU.

    python3 scripts/torch_time_conv_kernels.py [--checkout DIR] [--bits FILE]

Times, in bf16 with seeded operands, by CUDA events over 20 launches after 3
warm-up launches: B2 (``fused_conv3x3`` with the skip map, SwinIR serving's
264 x 264 x 180 map, its weights laid out as the checkout's serving path
lays them out: ``prepare_fused_conv3x3_weights`` where the checkout has it,
else HWIO) and its library yardstick (cuDNN's ``F.conv2d`` + add,
channels-last), B3 (``fused_upsample_x4``, 264 x 264 x 64), B4
(``fused_upsample_s`` at x2 and x3, 264 x 264 x 64), each tail on its
weights laid out as the checkout's serving path lays them out (packed by
``pack_tail`` where the checkout has it, else HWIO), beside the same tail as
a sequence of bf16 PyTorch calls (channels-last ``F.conv2d`` and
``F.pixel_shuffle``), B11
(``fused_cab_body``, HAT serving's 256 x 256 x 180 map, 180 -> 60 -> 180,
its convs packed once where the checkout has ``pack_cab_convs``, else HWIO)
beside the same function as a sequence of bf16 PyTorch calls
(``F.layer_norm``, channels-last cuDNN ``F.conv2d``, the exact ``F.gelu``,
``F.conv2d``, the sum over the map), and B14 (``fused_resblock``, SwinFIR's 264 x 264 x 180 map, LeakyReLU 0.2, its
weights packed as the checkout's serving path packs them where its B14
takes packed weights, else HWIO) beside cuDNN's two convs + LeakyReLU +
add, and B1 (``fused_swin_block``, the main path's 264 x 264 x 180 map, 6
heads, hidden 360, shift 4, its weights packed once where the checkout has
``pack_swin_weights``, else dense).

The per-pass split of B3, B4 and B11: ``torch.profiler`` over 10 calls of
each gives the device time of every kernel a call enqueues, in launch order
(B3 is three passes: conv0, conv1, conv_last; B4 two: conv0, conv_last; B11
four on the H100 route: LN, conv1, conv2, the sum).

Prints one JSON line: {"package": path, "card": nvidia-smi's name and power
limit, "ms": {kernel: ms}, "passes": {tail: [[kernel name, ms], ...]}}. The
package is whichever ``studiosr_tpu_torch`` is first on the path. With
``--checkout DIR`` the script instead runs itself four times, with
``PYTHONPATH`` set to DIR, this checkout, this checkout and DIR (A, B, B,
A on one card), prints each line and then a table of the four.

``--bits FILE`` writes the outputs of B1, B2, B3, B4, B11 and B14 on seeded
operands (bf16 at the serving geometries and ragged maps; f32, named
"(f32) ...", at the same and narrower ones; dense or HWIO weights, which
each checkout lays out its own way) to FILE (``torch.save``); with
``--checkout DIR`` it does so on DIR and on this tree, lists each output as
the same bits or by how far it moved, and exits 1 if any bf16 output
differs (f32 outputs that move are listed, not failed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 10


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pass_split(fn, calls: int = CALLS) -> list:
    """[[kernel name, device ms], ...] of the kernels one call of ``fn``
    enqueues, in launch order, each averaged over ``calls`` profiled calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))), key=lambda e: e.time_range.start)
    if not kernels or len(kernels) % calls:
        return [[f"{len(kernels)} device kernels in {calls} calls: no split", None]]
    per = len(kernels) // calls
    return [[kernels[i].name[:80], sum(k.time_range.elapsed_us() for k in kernels[i::per]) / calls / 1e3]
            for i in range(per)]


def tail_sequence(x, w0, b0, *rest):
    """The pixelshuffle tail as a sequence of bf16 PyTorch calls:
    channels-last ``F.conv2d`` (cuDNN) and ``F.pixel_shuffle``; ``rest`` is
    (w1, b1, w2, b2, 2) at x4, (w2, b2, s) at x2 / x3, weights OIHW."""
    import torch
    import torch.nn.functional as F

    *convs, s = rest
    y = x.permute(0, 3, 1, 2)
    y = F.pixel_shuffle(F.conv2d(y, w0, b0, padding=1), s)
    if len(convs) == 4:
        y = F.pixel_shuffle(F.conv2d(y.contiguous(memory_format=torch.channels_last), convs[0], convs[1], padding=1),
                            s)
    y = y.contiguous(memory_format=torch.channels_last)
    return F.conv2d(y, convs[-2], convs[-1], padding=1).permute(0, 2, 3, 1)


def cab_sequence(x, ln_w, ln_b, w1, b1, w2, b2):
    """B11 as a sequence of bf16 PyTorch calls: ``F.layer_norm``,
    channels-last ``F.conv2d`` (cuDNN), the exact ``F.gelu``, ``F.conv2d``
    and the f32 sum over the map; x NHWC, weights OIHW channels-last."""
    import torch
    import torch.nn.functional as F

    ln = F.layer_norm(x, (x.shape[-1],), ln_w.to(x.dtype), ln_b.to(x.dtype), 1e-5).permute(0, 3, 1, 2)
    h1 = F.gelu(F.conv2d(ln, w1, b1, padding=1))
    y2 = F.conv2d(h1, w2, b2, padding=1)
    return y2.permute(0, 2, 3, 1), y2.sum(dim=(2, 3), dtype=torch.float32)


def measure() -> dict:
    import torch
    import torch.nn.functional as F

    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, str(ROOT))
    import studiosr_tpu_torch
    from studiosr_tpu_torch import resolve_device
    from studiosr_tpu_torch.ops.cuda import conv3x3, swin_block, upsampler
    from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_cab_body, fused_conv3x3, fused_resblock
    from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block
    from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_s, fused_upsample_x4

    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def conv_w(cin, cout):
        return randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(bf), randn(cout, scale=0.1)

    def oihw(ops):
        return [t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t.to(bf)
                for t in ops]

    x = randn(1, 264, 264, 180).to(bf)
    w, b = conv_w(180, 180)
    w_oihw, b_lib, x_nchw = w.permute(3, 2, 0, 1).contiguous(), b.to(bf), x.permute(0, 3, 1, 2)
    prepare = getattr(conv3x3, "prepare_fused_conv3x3_weights", conv3x3.prepare_conv3x3_weights)
    w_b2 = prepare(w_oihw, bf)
    x64 = randn(1, 264, 264, 64).to(bf)
    tail = [*conv_w(64, 256), *conv_w(64, 256), *conv_w(64, 3)]
    tail_s = {s: [*conv_w(64, s * s * 64), *conv_w(64, 3)] for s in (2, 3)}
    seq_x4, seq_s = oihw(tail), {s: oihw(t) for s, t in tail_s.items()}
    pack_tail = getattr(upsampler, "pack_tail", None)  # the serving layout, where the checkout has one
    if pack_tail is not None:
        tail, tail_s = pack_tail(tail, 4), {s: pack_tail(t, s) for s, t in tail_s.items()}
    h = randn(1, 256, 256, 180).to(bf)
    cab = [1 + randn(180, scale=0.1), randn(180, scale=0.1), *conv_w(180, 60), *conv_w(60, 180)]
    cab_seq = oihw(cab)
    cab_seq[:2] = cab[:2]
    if hasattr(conv3x3, "pack_cab_convs"):  # packed once, as serving holds them
        cab[2], cab[4] = conv3x3.pack_cab_convs(cab[2], cab[4])
    res = [*conv_w(180, 180), *conv_w(180, 180)]
    res_oihw = [t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t.to(bf) for t in res]
    if "resblock_mma_bf16" in getattr(conv3x3, "_RES_SIGNATURES", {}):  # B14 reads packed weights
        res = [conv3x3.pack_conv3x3_weights(t) if t.dim() == 4 else t for t in res]

    def resblock_library():
        h1 = F.leaky_relu(F.conv2d(x_nchw, res_oihw[0], res_oihw[1], padding=1), 0.2)
        return x + F.conv2d(h1, res_oihw[2], res_oihw[3], padding=1).permute(0, 2, 3, 1)

    c, heads, hidden = 180, 6, 360
    block = [1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(c, 3 * c, scale=c**-0.5).to(bf),
             randn(3 * c, scale=0.1), randn(c, c, scale=c**-0.5).to(bf), randn(c, scale=0.1),
             randn(heads, 64, 64, scale=0.5), 1 + randn(c, scale=0.1), randn(c, scale=0.1),
             randn(c, hidden, scale=c**-0.5).to(bf), randn(hidden, scale=0.1),
             randn(hidden, c, scale=hidden**-0.5).to(bf), randn(c, scale=0.1)]
    if hasattr(swin_block, "pack_swin_weights"):  # packed once, as serving holds them
        packed = swin_block.pack_swin_weights(block[2], block[4], block[6], block[9], block[11], heads)
        block = [packed if i == 2 else None if i in (4, 6, 9, 11) else t for i, t in enumerate(block)]
    tails = {
        "fused_upsample_x4": lambda: fused_upsample_x4(x64, *tail),
        "fused_upsample_s x2": lambda: fused_upsample_s(x64, *tail_s[2], 2),
        "fused_upsample_s x3": lambda: fused_upsample_s(x64, *tail_s[3], 3),
    }
    ms = {
        "fused_conv3x3": time_ms(lambda: fused_conv3x3(x, w_b2, b, extra=x)),
        "fused_conv3x3 library (cuDNN conv2d + add)": time_ms(
            lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1).permute(0, 2, 3, 1) + x),
        **{name: time_ms(fn) for name, fn in tails.items()},
        "fused_upsample_x4 sequence (bf16 conv2d x3 + pixel_shuffle x2)": time_ms(
            lambda: tail_sequence(x64, *seq_x4, 2)),
        **{f"fused_upsample_s x{s} sequence (bf16 conv2d x2 + pixel_shuffle)": time_ms(
            lambda s=s: tail_sequence(x64, *seq_s[s], s)) for s in (2, 3)},
        "fused_cab_body": time_ms(lambda: fused_cab_body(h, *cab)),
        "fused_cab_body sequence (bf16 layer_norm, conv2d, gelu, conv2d, sum)": time_ms(
            lambda: cab_sequence(h, *cab_seq)),
        "fused_resblock": time_ms(lambda: fused_resblock(x, *res, activation="lrelu0.2")),
        "fused_resblock library (cuDNN conv2d x2 + leaky_relu + add)": time_ms(resblock_library),
        "fused_swin_block": time_ms(lambda: fused_swin_block(x, *block, heads=heads, window_size=8, shift=4)),
    }
    passes = {name: pass_split(fn) for name, fn in tails.items()}
    passes["fused_cab_body"] = pass_split(lambda: fused_cab_body(h, *cab))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"package": studiosr_tpu_torch.__file__, "card": card, "ms": ms, "passes": passes}


def kernel_bits() -> dict:
    """The ``--bits`` outputs, on the host."""
    import torch

    if "PYTHONPATH" not in os.environ:
        sys.path.insert(0, str(ROOT))
    from studiosr_tpu_torch import resolve_device
    from studiosr_tpu_torch.ops.cuda import _build
    from studiosr_tpu_torch.ops.cuda.conv3x3 import fused_cab_body, fused_conv3x3, fused_resblock
    from studiosr_tpu_torch.ops.cuda.swin_block import fused_swin_block
    from studiosr_tpu_torch.ops.cuda.upsampler import fused_upsample_s, fused_upsample_x4

    dev = resolve_device("cuda")
    _build.build(n for n in ("conv3x3", "swin_block", "swin_block_mma", "swin_block_f32", "upsampler", "resblock",
                             "cab_body", "cab_mma") if n in _build.SOURCES)  # a checkout builds what it has
    gen = torch.Generator().manual_seed(0)
    out = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "(f32)")):
        def w_(*shape, scale=1.0):
            return randn(*shape, scale=scale).to(dev, dt)

        def f_(*shape, scale=1.0):
            return randn(*shape, scale=scale).to(dev)

        for c, heads, shape, shift in ((180, 6, (1, 40, 56), 4), (180, 6, (1, 24, 24), 0), (32, 2, (2, 16, 24), 4)):
            hidden = 2 * c
            ops = [1 + f_(c, scale=0.1), f_(c, scale=0.1), w_(c, 3 * c, scale=c**-0.5), f_(3 * c, scale=0.1),
                   w_(c, c, scale=c**-0.5), f_(c, scale=0.1), f_(heads, 64, 64, scale=0.5), 1 + f_(c, scale=0.1),
                   f_(c, scale=0.1), w_(c, hidden, scale=c**-0.5), f_(hidden, scale=0.1),
                   w_(hidden, c, scale=hidden**-0.5), f_(c, scale=0.1)]
            out[f"{tag} B1 C {c} {shape} shift {shift}"] = fused_swin_block(
                w_(*shape, c), *ops, heads=heads, window_size=8, shift=shift)
        for cin, cout, act, residual, shape in ((180, 180, None, False, (1, 40, 56)), (180, 180, "lrelu0.2", True,
                                                                                      (1, 19, 37)),
                                                (20, 70, "relu", False, (2, 13, 21)), (64, 3, None, False, (1, 13, 27))):
            x = w_(*shape, cin)
            out[f"{tag} B2 {cin} -> {cout} {act} residual {residual} {shape}"] = fused_conv3x3(
                x, w_(3, 3, cin, cout, scale=(9 * cin) ** -0.5), f_(cout, scale=0.1), act, residual,
                w_(*shape, cout))
        for shape in ((1, 37, 53, 64), (1, 64, 64, 64)):
            tail = [w_(3, 3, 64, 256, scale=(9 * 64) ** -0.5), f_(256, scale=0.1),
                    w_(3, 3, 64, 256, scale=(9 * 64) ** -0.5), f_(256, scale=0.1),
                    w_(3, 3, 64, 3, scale=(9 * 64) ** -0.5), f_(3, scale=0.1)]
            out[f"{tag} B3 {shape}"] = fused_upsample_x4(w_(*shape), *tail)
            for s in (2, 3):
                tail_s = [w_(3, 3, 64, s * s * 64, scale=(9 * 64) ** -0.5), f_(s * s * 64, scale=0.1),
                          w_(3, 3, 64, 3, scale=(9 * 64) ** -0.5), f_(3, scale=0.1)]
                out[f"{tag} B4 x{s} {shape}"] = fused_upsample_s(w_(*shape), *tail_s, s)
        cab = [1 + f_(180, scale=0.1), f_(180, scale=0.1), w_(3, 3, 180, 60, scale=(9 * 180) ** -0.5),
               f_(60, scale=0.1), w_(3, 3, 60, 180, scale=(9 * 60) ** -0.5), f_(180, scale=0.1)]
        y2, sums = fused_cab_body(w_(1, 64, 64, 180), *cab)
        out[f"{tag} B11 output"], out[f"{tag} B11 sums"] = y2, sums
        for shape, act, res_scale in (((1, 37, 53, 48), "lrelu0.2", 1.0), ((1, 40, 40, 180), "relu", 0.1)):
            c = shape[-1]
            out[f"{tag} B14 {shape} {act} {res_scale}"] = fused_resblock(
                w_(*shape), w_(3, 3, c, c, scale=(9 * c) ** -0.5), f_(c, scale=0.5),
                w_(3, 3, c, c, scale=(9 * c) ** -0.5), f_(c, scale=0.1), res_scale, act)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def ab_bits(checkout: Path, path: Path) -> int:
    """``--bits`` on ``checkout`` and on this tree; 1 if any bf16 output differs."""
    import torch

    files = []
    for label, tree in (("parent", checkout), ("change", ROOT)):
        files.append(path.with_name(f"{path.name}.{label}"))
        env = dict(os.environ, PYTHONPATH=str(tree))
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--bits", str(files[-1])], env=env, cwd=tree,
                       check=True, timeout=1800)
    a, b = (torch.load(f, weights_only=True) for f in files)
    differ = sorted(k for k in a.keys() | b.keys() if k not in a or k not in b or not torch.equal(a[k], b[k]))
    for k in sorted(a):
        note = "the same bits"
        if k in differ and k in b and a[k].shape == b[k].shape:
            rel = float((a[k].double() - b[k].double()).abs().max() / a[k].double().abs().max().clamp_min(1e-30))
            note = f"differs (max |change - parent| / max |parent| {rel:.3e})"
        elif k in differ:
            note = "differs"
        print(f"{k}: {tuple(a[k].shape)} {a[k].dtype} {note}")
    return 1 if any("(f32)" not in k for k in differ) else 0


def ab(checkout: Path) -> None:
    """Run this script on ``checkout``, this tree, this tree, ``checkout``."""
    runs = []
    for label, tree in (("parent", checkout), ("change", ROOT), ("change", ROOT), ("parent", checkout)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve())], env=env, cwd=tree, capture_output=True,
                             text=True, check=True, timeout=1800).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"run": label, **line}), flush=True)
        runs.append((label, line))
    print("ms, " + " / ".join(label for label, _ in runs))
    for name in runs[0][1]["ms"]:
        print(f"  {name}: " + " / ".join(f"{line['ms'].get(name, float('nan')):.4f}" for _, line in runs))
    for name in runs[0][1]["passes"]:
        for label, line in runs:
            print(f"  {name} passes [{label}]: " + "; ".join(
                f"{k} {'n/a' if t is None else f'{t:.4f}'}" for k, t in line["passes"][name]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", type=Path, help="a second checkout to compare with: parent, this, this, parent")
    parser.add_argument("--bits", type=Path, metavar="FILE",
                        help="write B1, B2, B3, B4, B11 and B14's outputs on seeded operands (with --checkout: compare)")
    args = parser.parse_args()
    if args.bits and args.checkout:
        return ab_bits(args.checkout.resolve(), args.bits.resolve())
    if args.bits:
        import torch

        torch.save(kernel_bits(), args.bits)
    elif args.checkout:
        ab(args.checkout.resolve())
    else:
        print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
