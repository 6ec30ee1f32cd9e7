"""The readings that the check's limits are set from, at a cell's own size.

    python3 drift_bench/control.py --workload <cell> --seeds <a,b,...> \\
        --what <sound|int4|plan>

All seeds of one call run in one process, so the set-up's imports and
kernel builds are paid once. One JSON line per seed on standard output:

* ``sound``: the program as the cell runs it, one window batch per seed
  (``harness.run_cell`` with a zero-second window): the lower readings.
* ``int4``: the control: the plain reference put in the program's place
  with every protected GEMM at int4 (the precision below the
  configuration's int8), judged against the int8 reference exactly as
  the program is: the upper readings.
* ``plan``: the program's own narrowed path, the precision plan
  ``int8-body4`` (the denoiser's output at 4 bits from step
  ``nominal_steps`` on), as a second control.

The benchmark's own runs run none of this. Without a CUDA device it exits
non-zero, as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PLAN = {"precision": "int8-body4"}


def int4_reading(cell, seed: int, dev, log=None) -> dict:
    """The int4 control's numbers and verdict for one seed."""
    import torch
    from drift_bench import check, flips, seeds, weights
    from drift_bench.reference import REFERENCES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tr = cell.config, cell.traffic
    ref = REFERENCES[cfg["reference"]]
    params = weights.make(cfg, seed, dev)
    pool = flips.FlipPool(seed, tr["ber"], dev)
    req_seeds = [seeds.request_seed(seed, seeds.REQUEST_TAG, j)
                 for j in range(int(tr["bucket"]))]
    lat, cond, text = seeds.request_inputs(cfg, req_seeds, dev)
    plan = check.gemm_plan(seeds.mix64(seed, seeds.GEMM_TAG), cfg, tr)
    rec = check.reference_record(ref, cfg, params, tr, lat, cond, text,
                                 pool.factory(0), plan, bits=4)
    nums = check.numbers(
        ref, cfg, params, tr, rec, lat, cond, text, pool.factory(0),
        check.clean_steps(seeds.mix64(seed, seeds.CLEAN_STEP_TAG),
                          int(tr["steps"]), int(tr["check_clean_steps"])),
        log=log)
    correct, _ = check.judge(nums, cell.limits)
    return {"correct": correct, "check": nums}


def program_reading(cell, seed: int, dev, overrides=None, smoke=False,
                    log=None) -> dict:
    """The program's numbers and verdict for one seed, one batch."""
    from drift_bench import harness
    line = harness.run_cell(cell, seed, 0.0, False, device=str(dev),
                            smoke=smoke, request_overrides=overrides,
                            log=log if log is not None else sys.stderr)
    return {"correct": line["correct"],
            "check": {k: v["value"] for k, v in line["check"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("sound", "int4", "plan"),
                    required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from drift_bench import run, spec
    run.set_path()
    import torch
    cell = spec.load(args.workload, root=ROOT)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    for s in (int(x) for x in args.seeds.split(",")):
        if args.what == "int4":
            out = int4_reading(cell, s, torch.device("cuda"), log=sys.stderr)
        else:
            out = program_reading(cell, s, "cuda",
                                  PLAN if args.what == "plan" else None)
        torch.cuda.empty_cache()
        print(json.dumps(dict(workload=args.workload, what=args.what,
                              seed=s, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
