"""Core DRIFT machinery: quantization, faults, ABFT, rollback, DVFS, the execution context and metrics."""
