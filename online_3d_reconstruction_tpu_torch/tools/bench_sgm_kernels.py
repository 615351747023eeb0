"""Times of the SGM kernels on the card, beside their bounds: K1
(``sgm_cuda.aggregate``) and K2 (``sgm_cuda.run_total``) of the frame path,
and K3 (``sgm_cuda.scan_pair`` and its two passes alone).

    python online_3d_reconstruction_tpu_torch/tools/bench_sgm_kernels.py
        [--root DIR] [--label NAME] [--repeats 3] [--no-check] [--build-log FILE]
        [--only K1|K3]

It checks each kernel against its plain version (bit-equal on integer
inputs), then times, with CUDA events over back-to-back calls: one 8-path
aggregation at 384x512x64 (also 4 and 2 paths, D = 128, and fractional
penalties), in K1's float32 storage and its half form in bfloat16 (also at
P2 = 255, the largest its 32-bit words take) and float16, the four run
totals of one 384x512 speckle filter, and one run
total along each axis; the run totals also replayed from a CUDA graph, which
takes the host's launches out of the time; for K3, in float32 and bfloat16
storage, the forward pass, the backward pass and the pair at the vertical
pair's 384x512x64, and the pair at the horizontal pair's 512x384x64 and on
one skewed diagonal volume (384x895x64, 1e9 in its padding cells). Each time
stands beside its bound: the bytes the function must move (inputs read once,
outputs written once) at the H100's 3.35 TB/s. ``--root`` takes the package
from another checkout (an unpacked parent commit), so two versions can be
timed in one call on one card; run them in turns and compare only within the
call. ``O3R_NVCC_FLAGS`` in the environment reaches nvcc
(``-DO3R_K1_NO_UPDATE`` builds K1 without its update of the total: the time
of the dependent chains and the cost reads alone; ``-DO3R_K3_NO_STORE``
builds K3 without its stores: the chains and the loads alone; ``-Xptxas -v``
prints registers and shared memory). Prints one JSON
object per line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, 80 GB HBM3 (NVIDIA's data sheet)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def speckle_calls(sgm_cuda, device, h=384, w=512, seed=3):
    """The four (v, start, axis) calls of one speckle filter on a random
    disparity field with speckles."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    disp = torch.round(torch.rand((h, w), generator=gen) * 60 / 8) * 8
    disp = (disp + 0.2 * torch.randn((h, w), generator=gen)).to(device)
    val = (torch.rand((h, w), generator=gen) > 0.2).to(device).to(torch.float32)

    def start(axis):
        prev_v, prev_d = torch.roll(val, 1, axis), torch.roll(disp, 1, axis)
        conn = val * prev_v * ((disp - prev_d).abs() <= 1.0).to(torch.float32)
        conn.select(axis, 0).zero_()
        return (1.0 - conn).contiguous()

    f0, f1 = start(0), start(1)
    colrun = sgm_cuda.run_total_plain(val, f0, 0)
    rowrun = sgm_cuda.run_total_plain(val, f1, 1)
    return [(val, f0, 0), (val, f1, 1), (colrun, f1, 1), (rowrun, f0, 0)]


def skewed(cost, fill=1e9):
    """(H, W, D) sheared so the (1, 1) diagonals become columns of an
    (H, W + H - 1, D) volume, padding cells at ``fill`` (``sgm._skew``,
    written out here so that an older checkout can be timed too)."""
    import torch

    h, w, d = cost.shape
    padded = torch.nn.functional.pad(cost.flip(0), (0, 0, 0, h), value=fill)
    return padded.reshape(h * (w + h), d)[:h * (w + h - 1)].reshape(
        h, w + h - 1, d).flip(0).contiguous()


def bench_scan_pair(sgm_cuda, device, gen, say, bound_ms, args) -> None:
    """K3: checks against the plain version (bit-equal), then times."""
    import torch

    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    def launches(fn):
        cuda_build.reset_launch_counts()
        fn()
        return {k: v for k, v in cuda_build.launch_counts.items() if v}

    def volume(shape, dtype):
        return torch.randint(0, 33, shape, generator=gen).to(dtype).to(device)

    if not args.no_check:
        shapes = ((384, 512, 64), (37, 45, 40), (33, 70, 128), (9, 7, 200), (5, 3, 8),
                  (1, 4, 16), (2, 3, 24), (3, 2, 7), (1, 1, 1))
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                cost = volume(shape, dtype)
                want = sgm_cuda.scan_pair_plain(cost, 8.0, 32.0)
                fwd = torch.empty_like(cost)
                sgm_cuda.scan_launch("scan_fwd", cost, fwd, 8.0, 32.0)
                fwd_equal = torch.equal(fwd, sgm_cuda.scan_fwd_plain(cost, 8.0, 32.0))
                sgm_cuda.scan_launch("scan_bwd", cost, fwd, 8.0, 32.0)
                say(check="K3", shape=list(shape), dtype=str(dtype), fwd_equal=fwd_equal,
                    two_pass_equal=torch.equal(fwd, want),
                    pair_equal=torch.equal(sgm_cuda.scan_pair(cost, 8.0, 32.0), want))
        for dtype in (torch.float32, torch.bfloat16):
            cost = skewed(volume((37, 45, 40), torch.float32)).to(dtype)
            say(check="K3 skewed, 1e9 padding", shape=list(cost.shape), dtype=str(dtype),
                pair_equal=torch.equal(sgm_cuda.scan_pair(cost, 8.0, 32.0),
                                       sgm_cuda.scan_pair_plain(cost, 8.0, 32.0)))

    for _ in range(args.repeats):
        for dtype in (torch.float32, torch.bfloat16):
            cost = volume((384, 512, 64), dtype)
            out = torch.empty_like(cost)
            horizontal = cost.transpose(0, 1).contiguous()
            diagonal = skewed(cost.float()).to(dtype)
            pair = cuda_ms(lambda: sgm_cuda.scan_pair(cost, 8.0, 32.0), 50)
            say(kernel="K3", shape=[384, 512, 64], dtype=str(dtype),
                ms_fwd=cuda_ms(lambda: sgm_cuda.scan_launch("scan_fwd", cost, out, 8.0, 32.0), 50),
                ms_bwd=cuda_ms(lambda: sgm_cuda.scan_launch("scan_bwd", cost, out, 8.0, 32.0), 50),
                ms_pair=pair, launches_pair=launches(lambda: sgm_cuda.scan_pair(cost, 8.0, 32.0)),
                bound_ms_pair=bound_ms(cost, out), share_of_bound=bound_ms(cost, out) / pair,
                ms_pair_horizontal=cuda_ms(lambda: sgm_cuda.scan_pair(horizontal, 8.0, 32.0), 50),
                ms_pair_diagonal=cuda_ms(lambda: sgm_cuda.scan_pair(diagonal, 8.0, 32.0), 50),
                bound_ms_pair_diagonal=bound_ms(diagonal, diagonal))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="checkout whose package is timed (default: this one)")
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--no-check", action="store_true")
    parser.add_argument("--build-log", default="",
                        help="file for what nvcc printed (-Xptxas -v)")
    parser.add_argument("--only", default="", choices=("", "K1", "K3"),
                        help="check and time this kernel alone")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_sgm_kernels needs an NVIDIA card")
    from online_3d_reconstruction_tpu_torch.stereo import sgm_cuda
    from online_3d_reconstruction_tpu_torch.utils import cuda_build

    def say(**fields):
        print(json.dumps(dict(label=args.label, **fields)), flush=True)

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    cuda_build.load_kernels()
    say(card=smi, package=str(Path(sgm_cuda.__file__).resolve().parents[1]),
        build_s=cuda_build.build_seconds)
    if args.build_log:
        Path(args.build_log).parent.mkdir(parents=True, exist_ok=True)
        Path(args.build_log).write_text(getattr(cuda_build, "build_log", ""))

    gen = torch.Generator().manual_seed(0)

    def bound_ms(*tensors):
        return 1e3 * sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S

    if args.only != "K1":
        bench_scan_pair(sgm_cuda, device, gen, say, bound_ms, args)
    if args.only == "K3":
        return 0

    def cost_volume(shape, high=33):
        return torch.randint(0, high, shape, generator=gen, dtype=torch.uint8).to(device)

    cost = cost_volume((384, 512, 64))
    calls = speckle_calls(sgm_cuda, device)
    # K1's storage forms: bf16 and fp16 where this checkout has them (a
    # parent timed with --root may not)
    forms = [torch.float32]
    if "dtype" in inspect.signature(sgm_cuda.aggregate).parameters:
        forms.append(torch.bfloat16)
    if torch.float16 in getattr(sgm_cuda, "HALF_FORMATS", ()):
        forms.append(torch.float16)

    def k1(c, p1, p2, paths, dtype):
        if dtype == torch.float32:
            return sgm_cuda.aggregate(c, p1, p2, paths)
        return sgm_cuda.aggregate(c, p1, p2, paths, dtype)

    if not args.no_check:
        for shape, paths in (((384, 512, 64), 8), ((384, 512, 64), 4), ((96, 128, 128), 2),
                             ((37, 45, 40), 8), ((33, 70, 128), 8), ((70, 33, 8), 8),
                             ((21, 19, 256), 8), ((5, 3, 16), 4)):
            c = cost if shape == (384, 512, 64) else cost_volume(shape)
            for dtype in forms:
                got = k1(c, 8.0, 32.0, paths, dtype)
                want = sgm_cuda.aggregate_plain(c, 8.0, 32.0, paths, dtype)
                say(check="K1", shape=list(shape), paths=paths, dtype=str(dtype),
                    equal=torch.equal(got, want),
                    max_abs_err=float((got.float() - want.float()).abs().max()))
        for dtype in forms[1:]:
            a = k1(cost, 7.5, 30.5, 8, dtype)
            want = sgm_cuda.aggregate_plain(cost, 7.5, 30.5, 8, dtype)
            say(check="K1 fractional penalties", dtype=str(dtype), equal=torch.equal(a, want),
                runs_equal=torch.equal(a, k1(cost, 7.5, 30.5, 8, dtype)))
            # the half form at the largest P2 its words take and one past it
            high = cost_volume((96, 128, 64), high=256)
            for paths, p2 in ((8, 255), (8, 256 if dtype == torch.float16 else 255),
                              (8, 300), (4, 255), (2, 255)):
                say(check="K1 half form near its bound", dtype=str(dtype), paths=paths, p2=p2,
                    equal=torch.equal(k1(high, 8.0, float(p2), paths, dtype),
                                      sgm_cuda.aggregate_plain(high, 8.0, float(p2), paths,
                                                               dtype)))
        big = sgm_cuda.aggregate(cost, 8.0, 8000.0, 8)   # integer, too large to pack
        say(check="K1 P2 = 8000", equal=torch.equal(
            big, sgm_cuda.aggregate_plain(cost, 8.0, 8000.0, 8)))
        top = torch.full((72, 80, 8), 255, dtype=torch.uint8, device=device)
        top[:, :, 0] = 0    # interior sums reach 8 * (255 + 7936) = 65528: still 16 bits
        want = sgm_cuda.aggregate_plain(top, 7000.0, 7936.0, 8)
        say(check="K1 packed at its limit", max_sum=float(want.max()),
            equal=torch.equal(sgm_cuda.aggregate(top, 7000.0, 7936.0, 8), want))
        a = sgm_cuda.aggregate(cost, 7.5, 30.5, 8)
        b = sgm_cuda.aggregate(cost, 7.5, 30.5, 8)
        want = sgm_cuda.aggregate_plain(cost, 7.5, 30.5, 8)
        say(check="K1 fractional penalties", runs_equal=torch.equal(a, b),
            max_rel_err=float(((a - want).abs() / want.abs().clamp(min=1.0)).max()))
        shapes = [(384, 512), (61, 77), (40, 20), (9, 300), (600, 36), (3, 1100), (1, 1)]
        for h, w in shapes if args.only != "K1" else ():
            v = torch.randint(0, 4, (h, w), generator=gen).to(torch.float32).to(device)
            st = (torch.rand((h, w), generator=gen) > 0.7).to(torch.float32).to(device)
            for axis in (0, 1):
                got = sgm_cuda.run_total(v, st, axis)
                say(check="K2", shape=[h, w], axis=axis,
                    equal=torch.equal(got, sgm_cuda.run_total_plain(v, st, axis)))
        say(check="K2 speckle calls", equal=args.only == "K1" or all(
            torch.equal(sgm_cuda.run_total(*c), sgm_cuda.run_total_plain(*c)) for c in calls))

    def graph_ms(fn, iters=200):
        """Device ms of ``fn()`` replayed from a CUDA graph: no host gaps."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_ms(graph.replay, iters)

    total = torch.empty((384, 512, 64), dtype=torch.float32, device=device)
    zero_ms = cuda_ms(lambda: torch.zeros_like(total), 50)
    for _ in range(args.repeats):
        cuda_build.reset_launch_counts()
        sgm_cuda.aggregate(cost, 8.0, 32.0, 8)
        launches = cuda_build.launch_counts["sgm_path"]   # of one aggregation
        ms = cuda_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, 8), 50)
        say(kernel="K1", shape=[384, 512, 64], paths=8, ms=ms,
            launches=launches, bound_ms=bound_ms(cost, total),
            share_of_bound=bound_ms(cost, total) / ms, zeroing_ms=zero_ms,
            ms_paths4=cuda_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, 4), 50),
            ms_paths2=cuda_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, 2), 50),
            ms_fractional=cuda_ms(lambda: sgm_cuda.aggregate(cost, 7.5, 30.5, 8), 20))
        for dtype in forms[1:]:
            half = torch.empty((384, 512, 64), dtype=dtype, device=device)
            launches = {}
            for paths in (8, 4, 2):
                cuda_build.reset_launch_counts()
                k1(cost, 8.0, 32.0, paths, dtype)
                launches[paths] = cuda_build.launch_counts["sgm_path"]
            ms = cuda_ms(lambda: k1(cost, 8.0, 32.0, 8, dtype), 50)
            say(kernel=f"K1 {str(dtype).replace('torch.', '')}", shape=[384, 512, 64], paths=8,
                ms=ms, launches=launches[8],
                bound_ms=bound_ms(cost, half), share_of_bound=bound_ms(cost, half) / ms,
                ms_paths4=cuda_ms(lambda: k1(cost, 8.0, 32.0, 4, dtype), 50),
                launches_paths4=launches[4],
                ms_paths2=cuda_ms(lambda: k1(cost, 8.0, 32.0, 2, dtype), 50),
                launches_paths2=launches[2],
                ms_p2_255=cuda_ms(lambda: k1(cost, 8.0, 255.0, 8, dtype), 50),
                ms_fractional=cuda_ms(lambda: k1(cost, 7.5, 30.5, 8, dtype), 20))
        if args.only == "K1":
            continue
        four = cuda_ms(lambda: [sgm_cuda.run_total(*c) for c in calls], 200)
        val, f0, _ = calls[0]
        say(kernel="K2", shape=[384, 512], ms_four_calls=four,
            bound_ms_four_calls=4 * bound_ms(val, f0, val),
            share_of_bound=4 * bound_ms(val, f0, val) / four,
            ms_axis0=cuda_ms(lambda: sgm_cuda.run_total(*calls[0]), 200),
            ms_axis1=cuda_ms(lambda: sgm_cuda.run_total(*calls[1]), 200),
            graph_ms_four_calls=graph_ms(lambda: [sgm_cuda.run_total(*c) for c in calls]),
            graph_ms_axis0=graph_ms(lambda: sgm_cuda.run_total(*calls[0])),
            graph_ms_axis1=graph_ms(lambda: sgm_cuda.run_total(*calls[1])),
            graph_ms_K1=graph_ms(lambda: sgm_cuda.aggregate(cost, 8.0, 32.0, 8), 50))
    wide = cost_volume((384, 512, 128))
    for dtype in forms:
        say(kernel="K1", shape=[384, 512, 128], paths=8, dtype=str(dtype),
            ms=cuda_ms(lambda: k1(wide, 8.0, 32.0, 8, dtype), 20))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
