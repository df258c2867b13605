#!/usr/bin/env python3
"""Readings that the limits of ``portbench/limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload v1_arm2wh.train --seeds 1 2 3 --seconds 0

For each seed, in one process: the cell's set-up and a window of
``--seconds`` (at least one unit of its traffic), then, with the program's
state freed, the generator's ``calibrate``: the program's numbers against the
plain reference, the control's (the reference in the program's place, a
precision below the configuration's) and, for a training cell, a planted
fault's.  One JSON line per seed and kind on standard output (and appended to
``--out``).  Not part of a benchmark run; it needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from portbench.harness import core

    _, cfg, traffic, limits = core.cell_files(core.benchmark(), args.workload)
    mix = importlib.import_module(f"portbench.generators.{traffic['generator']}")
    for seed in args.seeds:
        cell = mix.Cell(cfg, traffic, seed, "cuda", core.Recorder())
        cell.window(args.seconds)
        cell.free()
        torch.cuda.empty_cache()
        for kind, checks in mix.calibrate(cell).items():
            line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                               "numbers": dict(checks), "limits": limits})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        del cell
    if core.loaded_forbidden():
        raise SystemExit(f"JAX modules were loaded: {core.loaded_forbidden()}")


if __name__ == "__main__":
    main()
