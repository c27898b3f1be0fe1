#!/usr/bin/env python3
"""The readings the limits of a cell's check are set from.

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control 1 2 3]

For each seed, in one process on the card: the job's set-up and one unit
at the cell's own size, then the numbers its check compares, for the
program as the configuration states it and, on the ``--control`` seeds,
for the control (the job's next precision below the configuration's).
The reference is computed once a seed.  One JSON line a reading, then the
largest of the program's and the smallest of the control's.  The
benchmark's own runs do not run this.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def readings(workload, seeds, control_seeds, device="cuda", overrides=None):
    spec = harness.load_spec()
    _, config, traffic = harness.find_cell(spec, workload)
    config = {**config, **(overrides or {})}
    make = harness.load_job(traffic).Job
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        want = None
        sides = [False] * (seed in seeds) + [True] * (seed in control_seeds)
        for control in sides:
            job = make(config, traffic, seed, device, control=control)
            job.setup()
            job.unit()
            job.release()
            if want is None:
                want = job.reference()
            checks = job.compare(want)
            row = {"seed": seed, "control": control,
                   **{k: v for k, (v, _, _) in checks.items()},
                   "notes": job.check_notes()}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control", type=int, nargs="*", default=[])
    args = parser.parse_args()
    rows = readings(args.workload, args.seeds, args.control)
    for control in (False, True):
        part = [r for r in rows if r["control"] == control]
        if not part:
            continue
        keys = [k for k in part[0] if k not in ("seed", "control", "notes")]
        pick = min if control else max
        print(json.dumps({"control" if control else "program": {
            k: pick(r[k] for r in part) for k in keys}}), flush=True)


if __name__ == "__main__":
    main()
