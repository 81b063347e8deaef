"""Build the CUDA kernels of ``kernels/csrc`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/kernels/lib<name>-<hash>.so`` under the repository root, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

then opened with ``ctypes``. The file name carries a hash of the source, so
an edited source builds anew and a stale library is never loaded. Nothing is
built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("slot_attention", "slot_attention_update")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Compile every named source that has no library yet, all ``nvcc``
    processes started together; raises with the compiler's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
