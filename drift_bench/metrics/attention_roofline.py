"""The self-attention kernel's share of its roofline over the traced
batch: each launch's least time (``counts.attention_work``: bf16 FLOPs at
the bf16 peak against q, k, v and o bytes) summed over the launches,
over the device time of ``flash_attention`` kernels. PixArt's
cross-attention runs the plain path and is not in it."""
from drift_bench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg = run.cell.config
    evals = t.drift_evals + t.clean_evals
    launches = t.launches.get("flash_attention", 0)
    if launches != evals * cfg["n_layers"]:
        return None
    work = counts.attention_work(int(run.cell.traffic["bucket"]),
                                 counts.tokens(cfg), cfg["n_heads"],
                                 cfg["head_dim"])
    device = t.time_s("flash_attention")
    if device <= 0:
        return None
    return 100.0 * counts.bound_s(work, run.peaks) * launches / device
