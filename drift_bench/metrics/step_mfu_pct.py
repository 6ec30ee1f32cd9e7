"""The model step's share of the chip's peak over the window: the least
time of the requested images' drift evaluations (the model's int8
projection operations at the int8 peak, its attention and adaLN FLOPs at
the bf16 peak; frozen counts, ``drift_bench/counts``) over the window's
host time. The engine's clean-reference evaluations are not counted."""
from drift_bench import counts


def read(run):
    if run.trace is None:
        return None
    ops = counts.model_ops_per_image(run.cell.config)
    per_image_s = (ops["int8_ops"] / run.peaks["int8_ops_per_s"]
                   + ops["flops"] / run.peaks["bf16_flops_per_s"])
    bucket = int(run.cell.traffic["bucket"])
    evals = sum(b["drift_evals"] for b in run.batches) * bucket
    return 100.0 * per_image_s * evals / run.window_s
