"""Share of a batch's host time in which no operation ran on the device:
1 - the traced batch's busy time (the union of its device operations'
intervals) over the median wall time of the window's untraced batches.
The traced batch's own wall is not the denominator: the profiler's host
cost stretches it (the harness prints the ratio), and a share of it would
move with the instrument."""
import statistics


def read(run):
    t = run.trace
    if t is None or not t.ops or not run.batch_walls:
        return None
    return 100.0 * (1.0 - t.busy_s() / statistics.median(run.batch_walls))
