"""Build and load the port's CUDA kernels.

Each `.cu` source has a plain C interface and is compiled by `nvcc`
into its own shared library, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds).  All sources build together, one `nvcc`
process each, started at once, on first use — never at import — into
`_build/` beside this file (listed in `.gitignore`).  Libraries are
named by a digest of their source, the headers beside it and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.

The build targets Hopper only (`sm_90a`), omits `--use_fast_math`
(the margin kernel relies on IEEE `expf`/`logf`) and turns off FMA
contraction (`-fmad=false`), so each kernel keeps its plain PyTorch
version's order of operations.  That does not make them bitwise equal:
on the profiling campaign's 12,288-cell slice the margin kernel differs
from its plain version in the last bits at 82,182,004 of 209,018,880
elements (max abs 1.9e-6, none beyond 2e-4; the cause is not isolated),
which matters where the margin fixed point amplifies last-bit
differences (see margin_grid.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

# kernel name -> source file, relative to this directory
SOURCES = {
    "margin_grid": Path("charge_sim") / "margin_grid.cu",
    "replay_blocks": Path("replay") / "replay.cu",
    "adaptive_blocks": Path("replay") / "adaptive.cu",
    "flash_attention": Path("flash_attention") / "flash_attention.cu",
    "wkv": Path("rwkv6") / "wkv.cu",
    "wkv_bwd": Path("rwkv6") / "wkv_bwd.cu",
    "mamba_scan": Path("mamba_scan") / "mamba_scan.cu",
}

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH): the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Content-addressed path of kernel `name`'s shared library: a
    digest of its source, the headers beside it (`*.cuh`) and the
    flags."""
    src = _HERE / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """Compiler output (ptxas register/spill report) of the last build."""
    return lib_path(name).with_suffix(".log")


def build_all() -> dict[str, Path]:
    """Compile every kernel whose library is missing, all `nvcc`
    processes in parallel; raise with the compiler output on failure.
    Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: lib_path(n) for n in SOURCES if not lib_path(n).is_file()}
    procs = {}
    nvcc = _nvcc() if todo else None
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_HERE / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):"
                          f"\n{text}")
            continue
        os.replace(tmp, out)          # atomic: readers never see a partial
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first
    if needed."""
    if name not in _LIBS:
        path = build_all()[name]
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
