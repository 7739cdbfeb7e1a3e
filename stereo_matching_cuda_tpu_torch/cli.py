"""Command-line entry of the PyTorch/CUDA port (counterpart of
``stereo_matching_cuda_tpu/cli.py``): the reference's main()
(main.cu:37-214) with every constant a flag, the 12 output PNGs of the
reference under --dump-intermediates, dataset scoring (--eval), frame
sequences (--sequence), a per-stage table (--profile), the HTTP
server (--serve) and the sharded multi-device path (--mesh).

Every mode runs on the card (``--device cuda``, the default) unless the
caller asks for the CPU with ``--device cpu``; on a machine with no CUDA
device, ``--device cuda`` is an error, not a fall back to the CPU.
``--oracle`` runs the port's exact plain path on the CPU, which is
bit-identical to the JAX package's NumPy oracle.

The JAX package's TPU scheduling flags (--staged, --y-sum, --vmem-mb,
--slice-group, --unroll-max, --sw-pipeline, --fast) and its compile
cache have no counterpart: the port's config has none of their fields
and compiles nothing per shape.

--mesh B,Y,X[,D] runs ``parallel.sharded_stereo_pipeline`` on the frame
broadcast B times, one rank per device: under a launcher (``torchrun``)
every rank runs the CLI and rank 0 writes the PNGs; a lone process forms
a one-rank group (NCCL on --device cuda, gloo on --device cpu).

Usage:
  python -m stereo_matching_cuda_tpu_torch left.png right.png -o outdir/
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from .config import StereoConfig
from .utils.io import read_image, write_mat_normalize, write_png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stereo_matching_cuda_tpu_torch",
        description="Cost-volume stereo with guided-filter aggregation on "
                    "PyTorch and hand-written CUDA kernels",
    )
    p.add_argument("left", nargs="?", default=None,
                   help="left image (PNG); dataset root with --eval; "
                        "omitted with --serve")
    p.add_argument("right", nargs="?", default=None,
                   help="right image (PNG); omitted with --eval/--serve")
    p.add_argument("-o", "--out", default=".", help="output directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on (default cuda; cpu runs "
                        "the plain path)")
    p.add_argument("--d-min", type=int, default=-15, help="min disparity (SystemIncludes.h:12)")
    p.add_argument("--d-max", type=int, default=0, help="max disparity (SystemIncludes.h:11)")
    p.add_argument("--alpha", type=float, default=0.9, help="gradient/color blend (SystemIncludes.h:10)")
    p.add_argument("--th-color", type=float, default=7.0, help="color truncation (SystemIncludes.h:14)")
    p.add_argument("--th-grad", type=float, default=2.0, help="gradient truncation (SystemIncludes.h:13)")
    p.add_argument("--radius", type=int, default=9, help="box filter radius (SystemIncludes.h:21)")
    p.add_argument("--eps", type=float, default=6.5025, help="guided filter eps (SystemIncludes.h:23)")
    p.add_argument("--d-lr", type=int, default=0, help="LR check tolerance (SystemIncludes.h:24)")
    p.add_argument("--d-chunk", type=int, default=None,
                   help="disparity slices per step of the plain path "
                        "(bounds its peak memory)")
    p.add_argument("--exact", action="store_true",
                   help="bit-exact parity mode (sequential integral images)")
    p.add_argument("--fused", choices=["auto", "on", "off"], default="auto",
                   help="hand-written CUDA matching kernel (CUDA only; "
                        "auto = on CUDA outside parity mode)")
    p.add_argument("--dual-view", choices=["auto", "on", "off"], default="auto",
                   help="compute both views in one kernel pass (auto = at "
                        "most 8 disparities)")
    p.add_argument("--stream", choices=["on", "off"], default=None,
                   help="row-walk matching kernel (K1 one view, K5 both) "
                        "instead of tiles (K3, K4); default: tiles for one "
                        "view, the row walk for both views from 200,000 px")
    p.add_argument("--oracle", action="store_true",
                   help="run the exact plain path on the CPU (bit-identical "
                        "to the NumPy golden oracle)")
    p.add_argument("--dump-intermediates", action="store_true",
                   help="write the reference's 12 debug PNGs (main.cu:162-181)")
    p.add_argument("--json", action="store_true", help="print timing/stats as one JSON line")
    p.add_argument("--gt", default=None,
                   help="ground-truth disparity PNG; adds bad-2.0 / EPE metrics")
    p.add_argument("--gt-scale", type=float, default=1.0,
                   help="GT PNG values are scale*|disparity| (e.g. 16 for Tsukuba GT)")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage table of ms per frame (stderr)")
    p.add_argument("--aggregation", choices=["guided", "box"], default="guided",
                   help="cost aggregation family: guided filter (reference "
                        "semantics) or plain box mean (SAD+box baseline)")
    p.add_argument("--mesh", default=None, metavar="B,Y,X[,D]",
                   help="run sharded over ranks: mesh sizes over (batch, "
                        "tile-rows, tile-cols, disparity-ranges), e.g. 1,2,4 "
                        "or 1,2,2,2; the world must have B*Y*X*D ranks")
    p.add_argument("--eval", action="store_true",
                   help="LEFT is a dataset root (Middlebury layout: scene "
                        "dirs with im0.png/im1.png, disp0.pfm GT, calib.txt "
                        "ndisp); prints per-scene and aggregate bad-2.0/EPE")
    p.add_argument("--sequence", action="store_true",
                   help="left/right are DIRECTORIES of same-shaped frames; "
                        "pairs are matched by sorted filename order and "
                        "processed frame by frame")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="run a long-lived HTTP serving process (POST "
                        "/disparity with base64 image pairs, GET /healthz)")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="bind address for --serve (default 127.0.0.1)")
    p.add_argument("--serve-warmup", default=None, metavar="HxW",
                   help="build the kernels and run HxW frames (one, and one "
                        "batch of --serve-batch) at startup, e.g. 288x384")
    p.add_argument("--serve-batch", type=int, default=8, metavar="N",
                   help="max micro-batch for --serve: concurrent same-shape "
                        "requests coalesce into one batched device pass; "
                        "1 disables batching (default 8)")
    p.add_argument("--serve-ranges", default=None, metavar="MIN:MAX[,...]",
                   help="allowlist of per-request d_min:d_max overrides for "
                        "--serve (e.g. '-15:0,-63:0'); others get 403. "
                        "Default: any range allowed")
    return p


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def _normalize(mat: np.ndarray) -> np.ndarray:
    return write_mat_normalize(np.asarray(mat, dtype=np.float32))


def _compute_fn(args):
    """(left, right, cfg, device) -> dict of numpy maps, for the chosen
    aggregation family."""
    if args.aggregation == "box":
        from .models.box import BoxStereoMatcher

        return lambda l, r, cfg, dev: BoxStereoMatcher(cfg, dev).compute(l, r)
    from .pipeline import compute_disparity

    return compute_disparity


def _run_sequence(args, cfg, device) -> int:
    """Directory mode: every pair through the pipeline, frame by frame
    (guided by default; --aggregation box uses the box model)."""
    compute = _compute_fn(args)
    lefts = sorted(glob.glob(os.path.join(args.left, "*")))
    rights = sorted(glob.glob(os.path.join(args.right, "*")))
    if len(lefts) != len(rights) or not lefts:
        return _error(f"need equal nonempty frame lists, got {len(lefts)} vs "
                      f"{len(rights)}")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    n = 0
    for lp, rp in zip(lefts, rights):
        try:
            left = read_image(lp)
            right = read_image(rp)
        except (OSError, ValueError, NotImplementedError) as e:
            return _error(f"{lp}/{rp}: {e}")
        if left.ndim != 3 or left.shape != right.shape or left.shape[2] < 3:
            return _error(f"{lp}/{rp}: need same-shaped color frames, got "
                          f"{left.shape} vs {right.shape}")
        if left.dtype != np.uint8 or right.dtype != np.uint8:
            return _error(f"{lp}/{rp}: frames must be 8-bit, got "
                          f"{left.dtype}/{right.dtype}")
        out = compute(left, right, cfg, device)
        stem = os.path.splitext(os.path.basename(lp))[0]
        write_png(os.path.join(args.out, f"{stem}_disparity.png"),
                  _normalize(out["occlusion_filled"]))
        n += 1
    dt = time.perf_counter() - t0
    stats = {"frames": n, "seconds": round(dt, 3),
             "fps": round(n / dt, 2) if dt else None}
    print(json.dumps(stats) if args.json else
          f"{n} frames in {dt:.2f} s ({stats['fps']} fps incl. PNG I/O)")
    return 0


def _run_mesh(args, left, right, cfg, device):
    """The sharded pipeline on ``left``/``right`` broadcast over the mesh's
    b axis: (dict of the first frame's numpy maps, this rank), or an exit
    code."""
    try:
        sizes = [int(v) for v in args.mesh.split(",")]
    except ValueError:
        sizes = []
    if len(sizes) == 3:
        sizes.append(1)
    if len(sizes) != 4 or min(sizes) < 1:
        return _error("--mesh wants B,Y,X or B,Y,X,D (positive integers)")
    b, y, x, d = sizes
    import torch.distributed as dist

    from .parallel import make_mesh, sharded_stereo_pipeline
    from .parallel.multihost import process_group

    with process_group("nccl" if device.type == "cuda" else "gloo"):
        try:
            mesh = make_mesh(b, y, x, d, device_type=device.type)
            out = sharded_stereo_pipeline(np.broadcast_to(left, (b, *left.shape)),
                                          np.broadcast_to(right, (b, *right.shape)), mesh, cfg)
        except ValueError as e:   # world size, tile sizes, divisibility
            return _error(str(e))
        rank = dist.get_rank()
    return {k: v[0].cpu().numpy() for k, v in out.items()}, rank


def _serve(args, cfg, device) -> int:
    for flag, on in [("--eval", args.eval), ("--sequence", args.sequence),
                     ("--oracle", args.oracle), ("--mesh", args.mesh),
                     ("positional image arguments", args.left)]:
        if on:
            return _error(f"--serve does not combine with {flag}")
    ranges = None
    if args.serve_ranges:
        try:
            ranges = [tuple(int(v) for v in part.split(":"))
                      for part in args.serve_ranges.split(",")]
            if any(len(r) != 2 for r in ranges):
                raise ValueError
        except ValueError:
            return _error(f"bad --serve-ranges {args.serve_ranges!r} "
                          "(want MIN:MAX[,MIN:MAX...])")
        # the configured range is always servable
        ranges.append((cfg.d_min, cfg.d_max))
    warmup_hw = None
    if args.serve_warmup:
        try:
            warmup_hw = tuple(int(v) for v in args.serve_warmup.split("x"))
            if len(warmup_hw) != 2 or any(v <= 0 for v in warmup_hw):
                raise ValueError
        except ValueError:
            return _error(f"bad --serve-warmup {args.serve_warmup!r} "
                          "(want HxW, e.g. 288x384)")
    if args.serve_batch < 1:
        return _error(f"--serve-batch must be >= 1, got {args.serve_batch}")
    from .serve import serve_forever

    serve_forever(args.serve_host, args.serve, cfg, ranges, warmup_hw,
                  max_batch=args.serve_batch, device=device)
    return 0


def _eval(args, cfg, device) -> int:
    if args.right is not None:
        return _error("--eval takes a single dataset root, not a pair")
    for flag, on in [("--mesh", args.mesh), ("--sequence", args.sequence),
                     ("--oracle", args.oracle),
                     ("--aggregation box", args.aggregation == "box"),
                     ("--profile", args.profile)]:
        if on:
            return _error(f"--eval does not support {flag}")
    from .evaluate import evaluate_dataset

    try:
        result = evaluate_dataset(args.left, cfg, args.gt_scale, device)
    except (OSError, ValueError, NotImplementedError) as e:
        return _error(str(e))
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    tristate = {"auto": "auto", "on": True, "off": False}
    if args.fused == "on" and args.exact:
        return _error("--fused on is incompatible with --exact (the fused "
                      "kernel is the fast path; WTA near-ties may flip)")
    try:
        cfg = StereoConfig(
            d_min=args.d_min, d_max=args.d_max, alpha=args.alpha,
            th_color=args.th_color, th_grad=args.th_grad, radius=args.radius,
            eps=args.eps, d_lr=args.d_lr, d_chunk=args.d_chunk,
            exact_integral=args.exact,
            fused=tristate[args.fused],
            dual_view=tristate[args.dual_view],
            stream=None if args.stream is None else args.stream == "on",
        )
    except ValueError as e:   # config validation (config.py __post_init__)
        return _error(str(e))
    if args.mesh and args.exact:
        return _error("--mesh does not support --exact (the sharded pipeline "
                      "uses per-tile window origins; run the parity mode on one "
                      "device)")
    if args.mesh and args.aggregation != "guided":
        return _error(f"--mesh only supports --aggregation guided, got "
                      f"{args.aggregation!r}")
    if args.oracle and args.aggregation != "guided":
        return _error("--oracle implements the reference (guided) pipeline "
                      "only; drop --aggregation box or --oracle")
    # --oracle computes on the CPU whatever --device says
    try:
        device = torch.device("cpu" if args.oracle else args.device)
    except RuntimeError as e:
        return _error(f"bad --device {args.device!r}: {e}")
    if device.type == "cuda" and not torch.cuda.is_available():
        return _error("--device cuda, but torch finds no CUDA device; pass "
                      "--device cpu to run the plain path on the CPU")
    if cfg.fused is True and device.type != "cuda":
        return _error("--fused on needs --device cuda (the CUDA kernels have "
                      "no CPU form); use --fused auto")
    if args.serve is not None:
        return _serve(args, cfg, device)
    if args.left is None:
        return _error("left image is required (or use --eval/--serve)")
    if args.eval:
        return _eval(args, cfg, device)
    if args.right is None:
        return _error("right image is required (or use --eval)")
    if args.sequence:
        # the sequence runner drives the pipeline only: reject modes it
        # would silently ignore
        for flag, on in [("--oracle", args.oracle), ("--mesh", args.mesh), ("--gt", args.gt),
                         ("--profile", args.profile),
                         ("--dump-intermediates", args.dump_intermediates)]:
            if on:
                return _error(f"--sequence does not support {flag}")
        return _run_sequence(args, cfg, device)
    t_io = time.perf_counter()
    try:
        left = read_image(args.left)
        right = read_image(args.right)
    except (OSError, ValueError, NotImplementedError) as e:
        return _error(str(e))
    t_io = time.perf_counter() - t_io
    if left.ndim != 3 or right.ndim != 3 or left.shape[2] < 3 or right.shape[2] < 3:
        return _error("inputs must be color images (H,W,3) or (H,W,4)")
    if left.dtype != np.uint8 or right.dtype != np.uint8:
        # 16-bit decode exists for --gt files; the matching pipeline's
        # contract (thresholds, grayscale truncation) is 8-bit
        return _error(f"input images must be 8-bit (got {left.dtype}/"
                      f"{right.dtype}; 16-bit PNGs are supported only for --gt)")
    if left.shape != right.shape:
        return _error(f"image shapes differ: {left.shape} vs {right.shape}")

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    if args.oracle:
        from .pipeline import compute_disparity

        exact = dataclasses.replace(cfg, exact_integral=True, fused=False,
                                    post_fused=False)
        out = compute_disparity(left, right, exact, device, full_outputs=True)
    elif args.mesh:
        ran = _run_mesh(args, left, right, cfg, device)
        if isinstance(ran, int):
            return ran
        out, rank = ran
        if rank != 0:       # rank 0 writes the outputs
            return 0
    elif args.aggregation == "box":
        out = _compute_fn(args)(left, right, cfg, device)
    else:
        from .pipeline import compute_disparity

        out = compute_disparity(left, right, cfg, device,
                                full_outputs=args.dump_intermediates)
    dt = time.perf_counter() - t0

    t_write = time.perf_counter()
    write_png(os.path.join(args.out, "disparity_mapl.png"), _normalize(out["disparity_left"]))
    write_png(os.path.join(args.out, "disparity_mapr.png"), _normalize(out["disparity_right"]))
    write_png(os.path.join(args.out, "occlu_mapl.png"), _normalize(out["occlusion"]))
    write_png(os.path.join(args.out, "occlu_mapl_filled.png"), _normalize(out["occlusion_filled"]))
    if args.dump_intermediates and "gray_left" not in out:
        print("note: --dump-intermediates intermediates are unavailable on "
              "this path (--mesh returns final maps only; --aggregation box "
              "has no guided-filter intermediates)", file=sys.stderr)
    if args.dump_intermediates and "gray_left" in out:
        write_png(os.path.join(args.out, "image_left.png"), out["gray_left"])
        write_png(os.path.join(args.out, "image_right.png"), out["gray_right"])
        write_png(os.path.join(args.out, "image_mean_left.png"), out["mean_left"])
        write_png(os.path.join(args.out, "image_mean_right.png"), out["mean_right"])
        write_png(os.path.join(args.out, "best_costl.png"), _normalize(out["best_cost_left"]))
        write_png(os.path.join(args.out, "best_costr.png"), _normalize(out["best_cost_right"]))
        write_png(os.path.join(args.out, "cost_lminus15.png"), _normalize(out["cost_left_s0"]))
        write_png(os.path.join(args.out, "cost_rminus15.png"), _normalize(out["cost_right_s0"]))
    t_io += time.perf_counter() - t_write

    from .metrics import occlusion_stats

    stats = {
        "height": int(left.shape[0]), "width": int(left.shape[1]),
        "disparities": cfg.size_d, "seconds": round(dt, 4),
        "io_seconds": round(t_io, 4),
        **occlusion_stats(out["occlusion"], cfg.v_min),
        "backend": "oracle" if args.oracle else device.type,
    }
    if args.gt:
        from .metrics import bad_pixel_rate, end_point_error

        try:
            gt_img = read_image(args.gt).astype(np.float32)
        except (OSError, ValueError, NotImplementedError) as e:
            return _error(str(e))
        if gt_img.ndim == 3:
            gt_img = gt_img[..., 0]
        # Middlebury PFM marks unknown pixels with inf; map them to the
        # metrics' gt_invalid value (0) so they are excluded
        gt_img = np.where(np.isfinite(gt_img), gt_img, np.float32(0))
        gt = gt_img / np.float32(args.gt_scale)
        disp = np.abs(np.asarray(out["occlusion_filled"], dtype=np.float32))
        stats["bad_2_0_pct"] = round(bad_pixel_rate(disp, gt, 2.0), 3)
        stats["epe"] = round(end_point_error(disp, gt), 3)
    if args.profile:
        if args.oracle or args.mesh or args.aggregation == "box":
            # the stage table covers the guided one-device pipeline;
            # profiling a different path than the one that produced the
            # outputs would mislead
            return _error("--profile covers the guided one-device pipeline; it "
                          "does not combine with --oracle/--mesh/--aggregation box")
        from .profiling import print_stage_table, stage_table

        print_stage_table(stage_table(left, right, cfg, device), file=sys.stderr)
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"duration: {dt:.3f} s   ({stats['width']}x{stats['height']}, "
              f"{cfg.size_d} disparities, {stats['occluded_pct']}% occluded)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
