"""Roofline analysis of the dry-run's reports on the H100's constants.

Counterpart of ``repro.launch.roofline``. Per (arch x shape x mesh) cell,
from the port's dry-run (``launch.dryrun``, one rank's counts through
``launch.op_analysis``):

  compute term    = flops / peak bf16 + int8_ops / peak int8
                    (989 TFLOP/s, 1979 TOP/s)
  memory term     = bytes / HBM rate                    (3.35 TB/s)
  collective term = collective_bytes / NVLink, one way  (450 GB/s)

The compute term adds an int8 term because the drift path's GEMMs run on
the int8 tensor cores; a report without ``int8_ops_per_device`` (the
reference's) reads it as 0, so the reference's report gives the
reference's row on the same constants. The dominant term is the
bottleneck; roofline fraction = compute term / max(all terms); useful
FLOPs = MODEL_FLOPS / ((per-rank FLOPs + int8 ops) x ranks), which the
port's model axis, every rank of it computing the whole block, pulls to
about 1/model.

The collective term is NVLink's: it does not model two ranks that share
one card over gloo through host memory (~1 GB/s, ``PERF.md`` section 5),
as the card checks' 2-rank meshes do.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dir experiments/dryrun_torch --markdown
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.perfmodel.hw import H100, H100_SXM


def _per_device(rep: Dict, name: str) -> float:
    """The port's per-rank key, or the reference's ``hlo_`` name of it."""
    for key in (f"{name}_per_device", f"hlo_{name}_per_device"):
        if key in rep:
            return rep[key] or 0
    return 0


def roofline_row(rep: Dict, hw: H100 = H100_SXM) -> Dict:
    flops = _per_device(rep, "flops")
    t_comp = (flops / hw.peak_flops_bf16
              + (rep.get("int8_ops_per_device") or 0) / hw.peak_ops_int8)
    t_mem = _per_device(rep, "bytes") / hw.hbm_bytes_per_s
    t_coll = (rep["collective_bytes_per_device"] or 0) / hw.link_bytes_per_s
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = (flops + (rep.get("int8_ops_per_device") or 0)) \
        * rep["n_devices"]
    useful = rep["model_flops"] / total if total else 0.0
    frac = t_comp / bound if bound > 0 else 0.0
    return {
        "arch": rep["arch"], "shape": rep["shape"], "opt": rep.get("opt", ""),
        "mesh": "x".join(str(m) for m in rep["mesh"]),
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": frac,
        "useful_flops_ratio": useful,
        "model_flops": rep["model_flops"],
        "flops_per_device": flops,
        "int8_ops_per_device": rep.get("int8_ops_per_device") or 0,
        "bytes_per_device": _per_device(rep, "bytes"),
        "collective_gb": (rep["collective_bytes_per_device"] or 0) / 1e9,
        "count_s": rep.get("count_s"),
    }


_ADVICE = {
    "compute": ("cut the model axis's duplicated compute (split each "
                "block's GEMMs over 'model' instead of gathering its "
                "weights whole) or padded/wasted GEMM work"),
    "memory": ("shrink the working set: fuse the eager elementwise chains "
               "into kernels, keep the KV cache in its dtype instead of "
               "f32 copies, windowed KV for local layers"),
    "collective": ("stop gathering whole weights per block: shard the "
                   "GEMMs on 'model', overlap the gathers with compute, "
                   "or compress payloads"),
}


def advice(row: Dict) -> str:
    return _ADVICE[row["dominant"]]


def load_rows(dir_: str, mesh: str = "", archs=()) -> List[Dict]:
    """The rows of every report in ``dir_``: only ``mesh``'s (a file name
    suffix, e.g. ``single`` or ``single_drift``) if given, only
    ``archs``' if given."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        if mesh and not path.endswith(f"_{mesh}.json"):
            continue
        with open(path) as f:
            rep = json.load(f)
        if not archs or rep["arch"] in archs:
            rows.append(roofline_row(rep))
    return rows


def to_markdown(rows: List[Dict]) -> str:
    """The reference's columns, with the per-rank counts before them."""
    hdr = ("| arch | shape | mesh | FLOPs/rank | int8 ops/rank | bytes/rank "
           "| collective GB/rank | compute s | memory s | collective s | "
           "dominant | roofline frac | useful FLOPs |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        shape = f"{r['shape']} ({r['opt']})" if r["opt"] else r["shape"]
        body += (f"| {r['arch']} | {shape} | {r['mesh']} "
                 f"| {r['flops_per_device']:.3e} "
                 f"| {r['int8_ops_per_device']:.3e} "
                 f"| {r['bytes_per_device']:.3e} | {r['collective_gb']:.3f} "
                 f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
                 f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
                 f"| {r['roofline_fraction']:.2f} "
                 f"| {r['useful_flops_ratio']:.3f} |\n")
    return hdr + body


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--arch", default="",
                    help="comma-separated archs to keep (default: all)")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(args.dir, args.mesh,
                     tuple(a for a in args.arch.split(",") if a))
    if args.markdown:
        print(to_markdown(rows))
        return
    for r in rows:
        print(f"{r['arch']:18s} {r['shape']:14s} {r['mesh']:8s} "
              f"C={r['t_compute_s']:.2e} M={r['t_memory_s']:.2e} "
              f"X={r['t_collective_s']:.2e} dom={r['dominant'][:4]} "
              f"frac={r['roofline_fraction']:.2f} "
              f"useful={r['useful_flops_ratio']:.3f}")
        print(f"    -> {advice(r)}")


if __name__ == "__main__":
    main()
