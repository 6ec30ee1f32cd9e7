"""Peak device memory over the window, less the benchmark's flip pool, in
GB: the CUDA caching allocator's peak of allocated bytes
(``torch.cuda.max_memory_allocated``, reset at the window's start), read
by the harness itself, the reading the result line's
``memory_peak_bytes`` gives too."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return (run.memory_peak_bytes - run.pool_bytes) / 1e9
