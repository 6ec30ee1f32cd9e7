"""The engine's clean-reference model evaluations over all its model
evaluations in the window (``EngineStats.clean_samples_computed`` times
the steps; each batch's ``n_model_evals``)."""


def read(run):
    drift = sum(b["drift_evals"] for b in run.batches)
    total = drift + run.clean_evals
    return 100.0 * run.clean_evals / total if total else None
