"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the program (``src/repro_torch``). The cell's configuration,
its reference model, mix, limits and per-layer readers are found by name
from the manifest.
The run needs as many CUDA devices as the cell's ``chips``; it exits 2,
printing no result, where there are fewer, and 3 where ``jax`` or the
JAX package was loaded in this process or in any rank's. The last line
on standard output is the result; the numbers compared with the plain
reference close standard error.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def cache_env(root: pathlib.Path) -> None:
    """The kernel caches at fixed paths inside the checkout, so only the
    first run of a checkout builds (the program's own kernels build into
    ``<root>/build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(root / "build" / sub)


def run(files: dict, seed: int, seconds: float, trace: bool, chips: int,
        device="cuda") -> dict:
    """Every part of the run (rank 0's first) and the result line; the
    set-up is counted from this process's start."""
    import harness
    mix = files["mix"]
    if mix["ranks"] == 1:
        parts = [harness.run_cell(files["config"], mix, files["limits"], seed, seconds,
                                  trace, device, t0=T0)]
    else:
        from repro_torch.launch.ranks import spawn_ranks
        parts = spawn_ranks(harness.rank_main, mix["ranks"],
                            (files, seed, seconds, trace, T0), device=device,
                            timeout=300, threads=2)
    return harness.result_line(parts, files, trace, chips, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "src" / "repro_torch").is_dir() or not manifest_path.is_file():
        print(f"no program under {ROOT / 'src'} or no manifest: nothing to run",
              file=sys.stderr)
        return 2
    cache_env(ROOT)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    import harness
    torch.set_num_threads(4)
    files = harness.cell_files(json.loads(manifest_path.read_text()), args.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        line = run(files, args.seed, args.seconds, bool(args.trace), chips)
    except harness.ForbiddenModules as e:
        print(e, file=sys.stderr)
        return 3
    bad = harness.loaded_forbidden()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    print("setup_phases_s " + " ".join(f"{k} {v:.3f}" for k, v in
                                       line["setup_phases_s"].items()), file=sys.stderr)
    if "first_step_spans_s" in line:
        print("first_step_spans_s " + " ".join(f"{k} {v:.3f}" for k, v in
                                               line["first_step_spans_s"].items()),
              file=sys.stderr)
    for name, c in line["check"].items():
        if c.get("left_out"):
            print(f"check {name} leaves out {' '.join(c['left_out'])}", file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
