#!/usr/bin/env python3
"""K5's final kept counts against its plain version on seeded mosaic
planes, on one CUDA card.

Each case is a [32, 512, 512] batch of chip_smoke.mosaic_planes at each of
chip_smoke.MOSAIC_SIGMAS.  For every plane where the kernel
(cuda_stats.clip_stats), the plain version in f32 and the plain version
in f64 (both on the card) do not all agree, and wherever
cuda_stats.stats_mismatch rejects the kernel, it prints the three kept
counts and the rule's verdict.

The planes come from one of two sources:
  - seeds: np.random.default_rng(s) for s in [first, first + seeds);
  - --parity-draws: the generator of chip_smoke.py's parity phase
    (np.random.default_rng(0)) after its K1 draws and the K3 draws that
    the named arrangement takes, i.e. the K5 planes chip_smoke.py checks
    when its K3 check draws that way.  "chip_smoke" is the committed
    arrangement (one draw of K3's main shape); "k3-shapes" also draws
    the noise of K3's other parity shapes from it; "k3-edges" also draws
    the main shape's edge cases from it; "k3-shapes-edges" does both.
With --stop it ends at the first case the rule rejects.  With
--per-iteration it also runs each case at maxiters = 0..5 (0: one set of
statistics over the valid pixels, no clip) and prints, for each k, the
planes where the kernel and the plain version in f32 differ in the kept
count, the median's bits, or mean, std, lower or upper (as a share of the
plane's scale), and the lowest k where anything differs.  Exits 0 once
every case has run (or --stop found one); the verdicts are printed.

Run from the repository root:
    python3 scripts/torch_k5_kept_probe.py [--first 0] [--seeds 40]
    python3 scripts/torch_k5_kept_probe.py --parity-draws k3-shapes
    python3 scripts/torch_k5_kept_probe.py --parity-draws k3-shapes-edges \
        --per-iteration
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DRAWS = ("chip_smoke", "k3-shapes", "k3-edges", "k3-shapes-edges")
# K3's parity shapes as chip_smoke.py drew them when its stream shape had
# two planes: the main path's, the eval path's, the stream route's
K3_SHAPES = ((32, 640, 640), (32, 132, 132), (2, 2048, 2048))


def parity_generator(draws: str):
    """np.random.default_rng(0) advanced as chip_smoke.py's parity phase
    advances it before its K5 planes: K1's candidates, then K3's planes
    as the arrangement `draws` takes them."""
    import numpy as np

    import chip_smoke as cs
    rng = np.random.default_rng(0)
    anchors = sum((cs.MAIN_SIZE // s) ** 2 for s in (8, 16, 32))
    for _ in (cs.PRE_NMS, 2048):
        for case, spread in (("random", 640.0), ("tied", 640.0),
                             ("crowded", 120.0)):
            cs.synthetic_detections(rng, cs.MAIN_BATCH, anchors, spread,
                                    tied=case == "tied")
    shapes = (K3_SHAPES if draws in ("k3-shapes", "k3-shapes-edges")
              else K3_SHAPES[:1])
    for p, h, w in shapes:
        rng.normal(0, 1, (p, h, w))
        # the 2%-over-60-decades edge case, on a plane past the seventh
        if draws in ("k3-edges", "k3-shapes-edges") and p > 7:
            n = h * w // 50
            rng.choice(h * w, n)
            rng.choice([-1.0, 1.0], n)
            rng.uniform(-30, 30, n)
    return rng


def check(torch, x, label) -> tuple[int, bool]:
    """(largest kept-count difference kernel - plain f32, rule failed)"""
    from caesar_yolo_tpu_torch.ops import cuda_stats
    from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain

    import chip_smoke as cs
    worst, failed = 0, False
    for sig in cs.MOSAIC_SIGMAS:
        got = cuda_stats.clip_stats(x, *sig)
        ref = clip_stats_plain(x, None, *sig)
        f64 = clip_stats_plain(x.double(), None, *sig)
        k, r, d = (t[1][:, 1].cpu().long() for t in (got, ref, f64))
        differ = (k != r) | (r != d)
        worst = max(worst, int((k - r).abs().max()))
        why = cuda_stats.stats_mismatch(got, ref)
        failed |= why is not None
        if bool(differ.any()) or why:
            print(f"{label} sigmas {sig}: planes "
                  f"{differ.nonzero().flatten().tolist()} kept by the "
                  f"kernel {k[differ].tolist()}, plain f32 "
                  f"{r[differ].tolist()}, plain f64 {d[differ].tolist()};"
                  f" rule: {why or 'ok'}", flush=True)
    return worst, failed


def per_iteration(torch, x, label) -> None:
    """The kernel against the plain version in f32 at maxiters = 0..5, each
    of chip_smoke.MOSAIC_SIGMAS: the planes that differ and how."""
    from caesar_yolo_tpu_torch.ops import cuda_stats
    from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain

    import chip_smoke as cs
    names = ("mean", "median", "std", "lower", "upper")
    for sig in cs.MOSAIC_SIGMAS:
        first = None
        for k in range(6):
            gs, gc = (t.cpu() for t in cuda_stats.clip_stats(x, *sig,
                                                              maxiters=k))
            rs, rc = (t.cpu() for t in clip_stats_plain(x, None, *sig,
                                                        maxiters=k))
            scale = rs.nan_to_num().abs().amax(dim=1).clamp(min=1e-30)
            rel = (gs - rs).nan_to_num().abs() / scale[:, None]
            med = gs[:, 1].nan_to_num().view(torch.int32) != rs[:, 1] \
                .nan_to_num().view(torch.int32)
            differ = (gc[:, 1] != rc[:, 1]) | med | (rel > 0).any(dim=1)
            for i in differ.nonzero().flatten().tolist():
                print(f"{label} sigmas {sig} maxiters {k} plane {i}: kept "
                      f"{int(gc[i, 1])} (kernel) {int(rc[i, 1])} (plain); "
                      f"median bits equal {not bool(med[i])}; "
                      + ", ".join(f"{n} {rel[i, j].item():.3g}"
                                  for j, n in enumerate(names))
                      + " of the plane's scale", flush=True)
            if first is None and bool(differ.any()):
                first = k
        print(f"{label} sigmas {sig}: first maxiters where the kernel and the "
              f"plain version differ: {first}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from caesar_yolo_tpu_torch.ops import cuda_stats

    parser = argparse.ArgumentParser()
    parser.add_argument("--first", type=int, default=0)
    parser.add_argument("--seeds", type=int, default=40)
    parser.add_argument("--parity-draws", choices=DRAWS)
    parser.add_argument("--stop", action="store_true",
                        help="stop at the first case the rule rejects")
    parser.add_argument("--per-iteration", action="store_true",
                        help="also compare at maxiters 0..5")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.parity_draws:
        cases = [(f"parity draws {args.parity_draws}",
                  lambda: parity_generator(args.parity_draws))]
    else:
        cases = [(f"seed {s}", lambda s=s: np.random.default_rng(s))
                 for s in range(args.first, args.first + args.seeds)]
    worst, rejected = 0, []
    for label, make in cases:
        x = cs.mosaic_planes(dev, make())
        w, failed = check(torch, x, label)
        if args.per_iteration:
            per_iteration(torch, x, label)
        worst = max(worst, w)
        if failed:
            rejected.append(label)
            if args.stop:
                break
    print(f"largest kept-count difference, kernel against plain f32: {worst} "
          f"(cuda_stats.KEPT_SLACK {cuda_stats.KEPT_SLACK}); cases the rule "
          f"rejects: {rejected or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
