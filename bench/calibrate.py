"""The readings that a cell's limits are set from, on the card: for each
seed the program's numbers against the plain reference (the lower
reading), the control's (the reference in float8, the upper reading),
those of the faults planted in the reference, and with ``--rounds`` those
of the program with its peel cut to so many rounds (a fault planted in
the program: the coordinates it leaves to the estimate). The benchmark's
own runs never run this.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 [--program-only]
                               [--rounds 1 2] [--mix <name>]

``--mix`` runs the cell's configuration under another mix of
``bench/mixes`` (a traffic that no cell runs yet).

One JSON line a seed, then one line of the largest program reading and
the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
VARIANTS = {"control": {"prec": "fp8"}, "half_batch": {"fault": "half_batch"},
            "no_exchange": {"fault": "no_exchange"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--rounds", type=int, nargs="*", default=[])
    ap.add_argument("--mix")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    import torch
    import harness
    import reference as ref_lib
    files = harness.cell_files(json.loads((ROOT / "BENCHMARK.json").read_text()),
                               args.workload)
    if args.mix:
        files["mix"] = harness.load_json(HERE / "mixes" / f"{args.mix}.json")
    cfg, mix = files["config"], files["mix"]
    dev = torch.device("cuda")
    rows = []
    for seed in args.seeds:
        part = harness.run_cell(cfg, mix, files["limits"], seed, 0.01, False, dev)
        row = {"seed": seed, "program": {k: v["value"] for k, v in part["readings"].items()},
               "leaf": {k: v.get("leaf") for k, v in part["readings"].items()},
               "left_out": part["readings"]["change_gap"]["left_out"],
               "recovery": part["recovery"]}
        for r in args.rounds:
            cut = copy.deepcopy(mix)
            cut["compression"]["rounds"] = r
            got = harness.run_cell(cfg, cut, files["limits"], seed, 0.01, False, dev)
            row[f"rounds_{r}"] = {k: v["value"] for k, v in got["readings"].items()}
        if not args.program_only:
            batches = ref_lib.make_batches(cfg, mix["global_batch"], mix["seq_len"], seed,
                                           range(mix["check_steps"]))
            ref = ref_lib.train_readings(cfg, mix, seed, batches, dev)
            for name, kw in VARIANTS.items():
                got = ref_lib.train_readings(cfg, mix, seed, batches, dev, **kw)
                row[name] = {k: v["value"] for k, v in ref_lib.compare(got, ref).items()}
            row["unchanged"] = {"change_gap": 1.0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for name in list(VARIANTS) + [f"rounds_{r}" for r in args.rounds]:
        if name in rows[0]:
            summary[name] = {k: min(r[name][k] for r in rows) for k in rows[0][name]}
    print(json.dumps({"workload": args.workload, "mix": args.mix, "seeds": args.seeds,
                      **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
