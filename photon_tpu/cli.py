"""Batch CLI: run simulations over a directory of parameter files.

Replacement for the reference's batch driver (C1 in SURVEY.md,
``python_codes/batch_run_simulation.py``): glob parameter files
(.json native, .mat for reference configs), slice with start-index/count
for job arrays, run each case, write artifacts, report timing.

Usage:
    python -m photon_tpu.cli <param_dir_or_file> [start_index] [count]
        [--out OUT_DIR]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from photon_tpu.config import SimulationConfig
from photon_tpu.pipeline import run_simulation, save_result
from photon_tpu.utils.compile_cache import enable_compile_cache


def _load_config(path: str) -> SimulationConfig:
    if path.endswith(".mat"):
        return SimulationConfig.from_mat(path)
    return SimulationConfig.from_json(path)


def make_sample(simulation_type: str, path: str) -> None:
    """Write a ready-to-run sample parameter file.

    Equivalent of the reference's create_sample_simulation_parameters.py
    (BOS: 1000 dots x 500 rays on a 1024^2 sensor; PIV: 5e4 particles x
    1e4 rays with Mie scattering, ref: :70-71).
    """
    from photon_tpu.config import default_config

    cfg = default_config(simulation_type)
    if simulation_type == "piv":
        cfg.particle_field.particle_number = 50_000
        cfg.particle_field.lightray_number_per_particle = 10_000
    cfg.output_data.image_directory = f"./{simulation_type}_images"
    cfg.to_json(path)
    print(f"wrote {simulation_type} sample parameters -> {path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="photon_tpu batch simulation runner")
    parser.add_argument("params", help="parameter file or directory of "
                        ".json/.mat parameter files")
    parser.add_argument("start_index", nargs="?", type=int, default=0,
                        help="first case index (job-array slicing)")
    parser.add_argument("count", nargs="?", type=int, default=None,
                        help="number of cases to run")
    parser.add_argument("--out", default=None,
                        help="output directory override")
    parser.add_argument("--make-sample", choices=("piv", "bos", "cal"),
                        default=None,
                        help="write a sample parameter file to PARAMS "
                        "and exit")
    args = parser.parse_args(argv)
    enable_compile_cache()

    if args.make_sample:
        make_sample(args.make_sample, args.params)
        return 0

    if os.path.isdir(args.params):
        files = sorted(glob.glob(os.path.join(args.params, "*.json"))
                       + glob.glob(os.path.join(args.params, "*.mat")))
    else:
        files = [args.params]
    if not files:
        print(f"no parameter files found in {args.params}", file=sys.stderr)
        return 1

    end = None if args.count is None else args.start_index + args.count
    files = files[args.start_index:end]

    t0 = time.time()
    for i, path in enumerate(files):
        print(f"[{i + 1}/{len(files)}] {path}")
        cfg = _load_config(path)
        out_dir = args.out or cfg.output_data.image_directory \
            or os.path.splitext(path)[0] + "_out"
        t1 = time.time()
        result = run_simulation(cfg)
        written = save_result(cfg, result, out_dir)
        print(f"    {len(written)} artifacts -> {out_dir}"
              f"  ({time.time() - t1:.1f}s)")
    print(f"TOTAL time taken (minutes): {(time.time() - t0) / 60.0:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
