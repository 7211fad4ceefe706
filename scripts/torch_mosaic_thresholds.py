#!/usr/bin/env python3
"""Catalog size and phase times of the port's tiled CLI run against the
score threshold, for a seeded random yolo11l.

Writes chip_smoke.py's mosaic (2560x2560, 400 sources, NaN-blanked
border) and seeded yolo11l weights, then runs `cli.run` tiled (512 px,
step 0.5, batch 32, bkg + chan3 + min-max) once per threshold on one
CUDA card, printing per run: tiles/s end to end, the tile and stitched
source counts, SFinderReport.phase_times and the K5/K6 launches.  A
random model's class scores sit at its head's bias priors, so the
catalog is empty above them and grows quickly below: this is how
chip_smoke.py's MOSAIC_SCORE_THR was chosen.

Run from the repository root:  python3 scripts/torch_mosaic_thresholds.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

THRESHOLDS = (1e-3, 2e-3, 3e-3, 5e-3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.models.convert import save_params
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops import cuda_histeq, cuda_stats
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits

    with tempfile.TemporaryDirectory() as tmp:
        image = os.path.join(tmp, "mosaic.fits")
        write_mosaic_fits(image, nx=2560, ny=2560, n_sources=400, seed=0,
                          blank_border=16)
        weights = save_params(init_weights(build_model("yolo11l"), seed=0),
                              os.path.join(tmp, "yolo11l_seed0.npz"),
                              meta={"model": "yolo11l", "num_classes": 5})
        for thr in THRESHOLDS:
            argv = [f"--image={image}", f"--weights={weights}",
                    "--split_img_in_tiles", "--tile_xsize=512",
                    "--tile_ysize=512", "--tile_xstep=0.5",
                    "--tile_ystep=0.5", "--max_ntasks_per_worker=1000",
                    "--batch_size=32", "--preprocessing", "--subtract_bkg",
                    "--chan3_preproc", "--sigma_clip_baseline=0",
                    "--sigma_clip_low=1", "--sigma_clip_up=20",
                    "--normalize_minmax", "--norm_min=0", "--norm_max=255",
                    f"--scoreThr={thr}",
                    f"--detect_outfile_json={tmp}/catalog.json",
                    f"--detect_outfile={tmp}/catalog.reg"]
            for fn in (cuda_stats.clip_stats,
                       cuda_histeq.equalize_hist_batch):
                fn.launches = 0
            t0 = time.perf_counter()
            rc, sf = cli_run.run(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rc != 0:
                print(f"FAIL: run at threshold {thr} returned {rc}")
                return 1
            objs = [o for tr in sf.last_tile_results for o in tr["objs"]]
            print(f"thr {thr}: {sf.report.n_tiles / wall:.2f} tiles/s "
                  f"({wall:.3f} s), {len(objs)} tile objects "
                  f"({sum(bool(o['edge']) for o in objs)} edge), "
                  f"{len(sf.sources['sources'])} stitched sources; "
                  f"phases {sf.report.phase_times}; launches K5 "
                  f"{cuda_stats.clip_stats.launches}, K6 "
                  f"{cuda_histeq.equalize_hist_batch.launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
