"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes)
exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The library lands in
``build/torch_kernels/`` beside the package, named by a hash of the source
and the flags, so it is rebuilt only when either changes; delete that
directory to force a rebuild.  Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import collections
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# --split-compile=0: nvcc optimises a source's kernels in parallel on every
# core, so the window kernels' seven radii (csrc/radius.cuh) do not add
# their compile times up
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

# Every kernel source under csrc/, by the name its library and its launch
# count go by
KERNELS = ("alt_corr_fwd", "alt_corr_bwd", "alt_corr_dcoords", "warp_fwd",
           "corr_lookup_fwd", "spatial_corr_fwd", "spatial_corr_bwd")

_LIBS: dict = {}
BUILD_SECONDS: dict = {}
# Launches of each hand-written kernel, counted by its wrapper where it
# launches the kernel (chip_smoke.py reads them to show the main path ran
# through the kernels).
LAUNCH_COUNTS: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of understanding_flow_robustness_tpu_torch are built "
            "from csrc/ at first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: keyed by source, the headers
    under ``csrc/`` and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_libraries(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` per source, all started together.  The compiler's
    resource report (``-Xptxas -v``) is kept beside each library as
    ``<lib>.log``; ``BUILD_SECONDS[name]`` is each build's wall time."""
    running = []
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, cmd, proc, tmp, out, time.perf_counter()))
    failed = []
    for name, cmd, proc, tmp, out, t0 in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name} ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            continue
        BUILD_SECONDS[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, compiling it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    import ctypes

    build_libraries([name])
    _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def kernel_fn(lib_name: str, symbol: str, argtypes):
    """(ctypes function ``symbol`` of csrc/<lib_name>.cu returning its
    cudaError_t as int, the library); every library also exports
    ``ufr_cuda_error_string``."""
    import ctypes

    lib = load_library(lib_name)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    lib.ufr_cuda_error_string.restype = ctypes.c_char_p
    lib.ufr_cuda_error_string.argtypes = [ctypes.c_int]
    return fn, lib
