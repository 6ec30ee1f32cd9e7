"""Elements the rollback replaced over the output words of the protected
GEMMs of the window's drift evaluations (each batch's
``batch_corrected_elems`` over its evaluations times one evaluation's
words, frozen counts)."""
from drift_bench import counts


def read(run):
    calls = counts.gemm_calls(run.cell.config,
                              int(run.cell.traffic["bucket"]))
    words = sum(g.m * g.n for g in calls) \
        * sum(b["drift_evals"] for b in run.batches)
    corrected = sum(b["corrected"] for b in run.batches)
    return 100.0 * corrected / words if words else None
