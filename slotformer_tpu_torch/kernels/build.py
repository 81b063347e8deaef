"""Build the CUDA kernels of ``kernels/csrc`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/kernels/lib<name>-<hash>.so`` under the repository root, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -I csrc

then opened with ``ctypes``. The sources share headers (``csrc/*.cuh``), so
the file name carries a hash of every file under ``csrc``: an edited source
or header builds anew and a stale library is never loaded. The compiler's
output (``-Xptxas -v``: each kernel's registers, shared memory and spills)
is kept beside the library as ``lib<name>-<hash>.log``. Nothing is built or
imported when this module is imported.
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
KERNEL_SOURCES = ("slot_attention", "slot_attention_update", "decoder_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built on first use and need the CUDA toolkit")
    return path


def source_digest() -> str:
    """A hash of every file under ``csrc`` (names and contents)."""
    h = hashlib.sha1()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest()}.so"


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``csrc/<name>.cu``."""
    return _lib_path(name).with_suffix(".log").read_text()


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
            out.with_suffix(".log").write_text(log)
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
