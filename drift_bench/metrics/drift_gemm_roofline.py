"""The fused DRIFT GEMM's share of its roofline over the traced batch:
the sum of each call's least time (frozen counts of its int8 operations
and bytes, ``counts.drift_gemm_work``) over the sum of the device time of
its launches (the GEMM kernel and, where the call has one, its transpose
of B). The calls are the batch's evaluations times one evaluation's
protected GEMMs; a call reads flips where its class and step run at a
BER above 0, and checkpoint words for its masked elements: the batch's
corrected count, spread over the faulted calls by their words. Nothing
is read when the launches counted differ from the calls expected."""
from drift_bench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    calls = counts.gemm_calls(cfg, int(tr["bucket"]))
    evals = t.drift_evals + t.clean_evals
    if t.launches.get("drift_gemm_fused") != evals * len(calls):
        return None
    faulted = [g for step in range(t.drift_evals) for g in calls
               if counts.ber_at(tr, step, g.scope) > 0]
    words = sum(g.m * g.n for g in faulted)
    if t.corrected and not words:
        return None
    bound = sum(counts.bound_s(counts.drift_gemm_work(g.m, g.k, g.n),
                               run.peaks) for g in calls) * evals
    for g in faulted:
        plain = counts.bound_s(counts.drift_gemm_work(g.m, g.k, g.n),
                               run.peaks)
        reads = t.corrected * g.m * g.n / words
        bound += counts.bound_s(counts.drift_gemm_work(
            g.m, g.k, g.n, g.m * g.n, reads), run.peaks) - plain
    device = t.time_s("drift_gemm_kernel", "transpose_kernel")
    return 100.0 * bound / device if device > 0 else None
