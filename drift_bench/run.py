"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 drift_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch`` (the port,
which this puts on ``sys.path``) and ``BENCHMARK.json``. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``, each compared number beside its limit, which also end
standard error. Without a CUDA device, or with fewer than the cell asks
for, or when JAX or the JAX package was loaded, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_path() -> None:
    """The checkout's root on ``sys.path`` in place of this folder, so that
    no module here shadows a top-level one; and the port, under ``src``."""
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "drift_bench"]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level module names the process may not hold: JAX and the JAX
#: package the port was made from, compared whole (``repro_torch`` is not
#: ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (``sys.modules``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_path()
    for k, v in CACHE_DIRS.items():
        os.environ[k] = str(ROOT / v)

    from drift_bench import spec
    cell = spec.load(args.workload, root=ROOT)
    import torch
    found = (torch.cuda.device_count() if torch.cuda.is_available()
             else 0)
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    from drift_bench import harness
    line = harness.run_cell(cell, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
