"""The port's banded crash-resume drill: the twin of
scripts/drill_banded_resume.py for caesar_yolo_tpu_torch.

A mosaic past the device-tiling cap takes the banded path (one full-width
band per grid row crosses to the device); a crashed run restarts from its
spool.  Three runs of the tiled CLI's configuration, each a subprocess,
with the cap forced to one band's bytes so that "auto" picks the bands:
  A. uninterrupted        -> the catalog and the throughput
  B. SIGKILLed once its spool holds `--kill_after` records
  C. --resume from B's spool -> must skip B's tiles and write A's catalog,
                               bit for bit
Prints one JSON summary (Mpix/s, bands and bytes shipped, tiles resumed
against recomputed) as its last line and exits non-zero on a mismatch.

    python3 scripts/torch_drill_banded_resume.py [workdir] [--size 16384]
        [--kill_after K] [--timeout S] [-- CLI flags]

The CLI flags (cli.run's) default to the trained yolov8n_synth96 fixture
at 96 px tiles, step 0.5, batch 128, min-max preprocessing, on CUDA; pass
--devices=cpu among them to rehearse on the CPU.  The workdir (default
build/drill) holds the mosaic, made once from a seed, the spools, the
catalogs and each run's log.  chip_smoke.py runs the same drill at its
mosaic phase's size through `drill`.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import replace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from caesar_yolo_tpu_torch.cli import run as cli_run  # noqa: E402
from caesar_yolo_tpu_torch.cli.preproc_args import (  # noqa: E402
    build_preprocessor_from_args,
)
from caesar_yolo_tpu_torch.parallel.sfinder import SFinder  # noqa: E402
from caesar_yolo_tpu_torch.utils.fits import get_fits_header  # noqa: E402
from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits  # noqa: E402
from caesar_yolo_tpu_torch.utils.tiling import generate_tiles  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "fixtures", "yolov8n_synth96.npz")
DEFAULT_FLAGS = [f"--weights={FIXTURE}", "--imgsize=96", "--scoreThr=0.3",
                 "--preprocessing", "--normalize_minmax",
                 "--split_img_in_tiles", "--tile_xsize=96",
                 "--tile_ysize=96", "--tile_xstep=0.5", "--tile_ystep=0.5",
                 "--batch_size=128", "--max_ntasks_per_worker=10000000"]


def synthesize(path: str, size: int, seed: int = 7) -> None:
    """The drill's mosaic, as the JAX drill makes it (sources sized for
    the 96 px fixture)."""
    n_src = max(200, (size // 96) ** 2 // 8)
    write_mosaic_fits(path, nx=size, ny=size, n_sources=n_src, seed=seed,
                      noise_sigma=0.08, amp_range=(3.0, 8.0),
                      sigma_range=(4.0, 7.0))


def band_bytes(cli_flags: list[str]) -> int:
    """One band's f32 bytes for the mosaic and tile height the flags
    name: the cap that makes "auto" ship bands."""
    args = cli_run.parse_args(cli_flags)
    return int(get_fits_header(args.image)["NAXIS1"]) * args.tile_ysize * 4


def run_with_cap(cli_flags: list[str], cap: int):
    """The tiled run cli.run makes of cli_flags, with the device-tiling cap
    forced to `cap` bytes (the CLI has no flag for it) -> (rc, SFinder)."""
    args = cli_run.parse_args(cli_flags)
    cfg = replace(cli_run.config_from_args(args),
                  device_tiling_max_bytes=cap)
    sf = SFinder(cli_run.load_model_from_args(args), cfg,
                 preprocessor=build_preprocessor_from_args(args),
                 device=args.devices or None)
    return sf.run_tiled(), sf


def worker(argv: list[str]) -> int:
    """One drill run (run_with_cap); writes its report as JSON."""
    p = argparse.ArgumentParser()
    p.add_argument("--cap", type=int, required=True)
    p.add_argument("--report", required=True)
    own, cli_flags = p.parse_known_args(argv)
    rc, sf = run_with_cap(cli_flags, own.cap)
    rep = sf.report
    with open(own.report, "w") as f:
        json.dump({"rc": rc, "runtime_s": rep.runtime_s,
                   "n_tiles": rep.n_tiles, "n_resumed": rep.n_resumed,
                   "tiling_mode": rep.tiling_mode,
                   "h2d_bytes": rep.h2d_bytes, "read_s": rep.read_s,
                   "phase_times": rep.phase_times,
                   "n_sources": rep.n_sources,
                   "tile_errors": len(rep.tile_errors)}, f)
    return rc


def _launch(workdir: str, name: str, cli_flags: list[str], cap: int,
            spool: str, resume: bool = False) -> subprocess.Popen:
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           f"--cap={cap}", f"--report={os.path.join(workdir, name)}.report",
           *cli_flags,
           f"--detect_outfile_json={os.path.join(workdir, name)}.json",
           f"--spool_path={spool}"]
    if resume:
        cmd.append("--resume")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    log = open(os.path.join(workdir, f"{name}.log"), "w")
    with log:
        return subprocess.Popen(cmd, cwd=workdir, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def _records(spool: str) -> int:
    """Complete tile records in a spool (its first line is the grid
    signature)."""
    try:
        with open(spool) as f:
            return max(0, sum(line.endswith("\n") for line in f) - 1)
    except FileNotFoundError:
        return 0


def _finish(proc: subprocess.Popen, timeout: float) -> int:
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"drill run did not finish in {timeout} s")


def _report(workdir: str, name: str) -> dict:
    with open(os.path.join(workdir, f"{name}.report")) as f:
        return json.load(f)


def _tail(workdir: str, name: str) -> str:
    with open(os.path.join(workdir, f"{name}.log")) as f:
        return f.read()[-4000:]


def drill(workdir: str, cli_flags: list[str], kill_after: int,
          cap: int | None = None, timeout: float = 600.0) -> dict:
    """Runs A, B (SIGKILLed once its spool holds kill_after records) and C
    (resumed from B's spool) of the tiled CLI with cli_flags (which name
    the image) under the device-tiling cap (default: one band's bytes)
    and returns the summary; raises RuntimeError when a run fails or the
    kill does not land mid-run."""
    workdir = os.path.abspath(workdir)     # the runs' working directory
    os.makedirs(workdir, exist_ok=True)
    cap = band_bytes(cli_flags) if cap is None else cap

    spool_a = os.path.join(workdir, "spool_A.jsonl")
    spool_b = os.path.join(workdir, "spool_B.jsonl")
    for spool in (spool_a, spool_b):
        if os.path.exists(spool):
            os.remove(spool)
    t0 = time.perf_counter()
    if _finish(_launch(workdir, "cat_A", cli_flags, cap, spool_a),
               timeout) != 0:
        raise RuntimeError("run A failed:\n" + _tail(workdir, "cat_A"))
    wall_a = time.perf_counter() - t0
    rep_a = _report(workdir, "cat_A")

    pb = _launch(workdir, "cat_B", cli_flags, cap, spool_b)
    t_b = time.perf_counter()
    while (pb.poll() is None and _records(spool_b) < kill_after
           and time.perf_counter() - t_b < timeout):
        time.sleep(0.005)
    exited = pb.poll() is not None
    if not exited:
        pb.send_signal(signal.SIGKILL)
    pb.wait()
    done_before = _records(spool_b)
    if exited:
        raise RuntimeError(f"run B ended (rc {pb.returncode}) before it was "
                           f"killed: the kill did not land mid-run\n"
                           + _tail(workdir, "cat_B"))
    if not 0 < done_before < rep_a["n_tiles"]:
        raise RuntimeError(f"run B was killed with {done_before} of "
                           f"{rep_a['n_tiles']} tiles spooled")

    t0 = time.perf_counter()
    pc = _launch(workdir, "cat_C", cli_flags, cap, spool_b, resume=True)
    if _finish(pc, timeout) != 0:
        raise RuntimeError("run C failed:\n" + _tail(workdir, "cat_C"))
    wall_c = time.perf_counter() - t0
    rep_c = _report(workdir, "cat_C")

    cats = {}
    for name in ("A", "C"):
        with open(os.path.join(workdir, f"cat_{name}.json")) as f:
            cats[name] = json.load(f)["sources"]
    args = cli_run.parse_args(cli_flags)
    header = get_fits_header(args.image)
    nx, ny = int(header["NAXIS1"]), int(header["NAXIS2"])
    return {
        "mosaic": f"{nx}x{ny} f32 ({nx * ny * 4 / 2 ** 30:.3f} GiB)",
        "mode": f"{rep_a['tiling_mode']} (cap {cap} bytes)",
        "n_tiles": rep_a["n_tiles"],
        "grid_rows": len({(y0, y1) for _, _, y0, y1 in generate_tiles(
            0, nx - 1, 0, ny - 1, args.tile_xsize, args.tile_ysize,
            args.tile_xstep, args.tile_ystep)}),
        "h2d_bytes_A": rep_a["h2d_bytes"],
        "runtime_A_s": rep_a["runtime_s"],
        "mpix_per_s_A": nx * ny / 1e6 / rep_a["runtime_s"],
        "tiles_per_s_A": rep_a["n_tiles"] / rep_a["runtime_s"],
        "phase_times_A": rep_a["phase_times"],
        "read_s_A": rep_a["read_s"],
        "killed_with_spooled_tiles": done_before,
        "resumed_tiles_C": rep_c["n_resumed"],
        "recomputed_tiles_C": rep_c["n_tiles"] - rep_c["n_resumed"],
        "runtime_C_s": rep_c["runtime_s"],
        "n_sources": rep_a["n_sources"],
        "catalog_identical_after_resume": cats["A"] == cats["C"],
        "wall_A_s": wall_a, "wall_C_s": wall_c,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return worker(argv[1:])
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?",
                   default=os.path.join(REPO, "build", "drill"))
    p.add_argument("--size", type=int, default=16384)
    p.add_argument("--kill_after", type=int, default=0,
                   help="spooled records at which run B is killed (default "
                   "half the tiles)")
    p.add_argument("--timeout", type=float, default=1800.0,
                   help="seconds each run may take")
    p.add_argument("cli_flags", nargs="*",
                   help="cli.run flags after --, replacing the defaults")
    args = p.parse_args(argv)
    args.workdir = os.path.abspath(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    mosaic = os.path.join(args.workdir, f"mosaic_{args.size}.fits")
    if not os.path.exists(mosaic):
        t0 = time.perf_counter()
        synthesize(mosaic, args.size)
        print(f"[drill] synthesized {mosaic} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    flags = [f"--image={mosaic}", *(args.cli_flags or DEFAULT_FLAGS)]
    kill_after = args.kill_after
    if not kill_after:
        a = cli_run.parse_args(flags)
        n = len(generate_tiles(0, args.size - 1, 0, args.size - 1,
                               a.tile_xsize, a.tile_ysize, a.tile_xstep,
                               a.tile_ystep))
        kill_after = n // 2
    try:
        summary = drill(args.workdir, flags, kill_after,
                        timeout=args.timeout)
    except RuntimeError as e:
        print(f"[drill] FAILED: {e}", flush=True)
        return 1
    print(json.dumps(summary), flush=True)
    return 0 if summary["catalog_identical_after_resume"] else 2


if __name__ == "__main__":
    sys.exit(main())
