"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled on first
use, by its own ``nvcc`` process, into ``build/repro_torch_kernels/`` at the
repo root (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the source, the headers of ``csrc`` (``*.cuh``, which the
sources include) and the flags, so an edited kernel or header rebuilds and
an unchanged one is reused. ``build_all`` starts one ``nvcc`` per stale
source, all at once, and waits for them. Libraries load with ``ctypes``;
every C launcher returns ``cudaGetLastError()`` after its launch and
``check`` raises on anything other than 0 (cudaSuccess). Nothing here
runs at import time: this module imports on machines without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("abft_matmul", "rollback_correct", "drift_gemm",
           "flash_attention", "fault_inject", "stat_abft")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "repro_torch kernels are built on a machine with the "
                       "CUDA toolkit")


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the headers of ``csrc``."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{source_hash(name)}.so"


def build_all(names: Iterable[str] = KERNELS,
              ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every stale kernel, one ``nvcc`` each, in parallel.

    Returns ``{name: compiler stderr}`` for the kernels built now (with
    ``ptxas_verbose`` that holds each kernel's registers and spills).
    Raises with the compiler's output when a build fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas=-v",) if ptxas_verbose else ()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True), tmp)
    logs, failed = {}, []
    for n, (p, tmp) in procs.items():
        out, err = p.communicate()
        logs[n] = out + err
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def function(lib_name: str, symbol: str, argtypes: Sequence):
    """The C launcher ``symbol`` of kernel ``lib_name``, built and loaded on
    first use, with ``argtypes`` set and an int (cudaError_t) result."""
    lib = _loaded.get(lib_name)
    if lib is None:
        build_all([lib_name])
        lib = _loaded[lib_name] = ctypes.CDLL(str(library_path(lib_name)))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
