"""Device operations of the traced batch over its protected GEMMs (the
port's ``drift_gemm_fused`` launch counter): what one protected GEMM
costs in launches, with everything around it."""


def read(run):
    t = run.trace
    if t is None or not t.launches.get("drift_gemm_fused"):
        return None
    return len(t.ops) / t.launches["drift_gemm_fused"]
