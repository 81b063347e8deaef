"""ctypes loader for the native (C) helpers under ``native/``: the port's
copy of ``slotformer_tpu/native.py``.

The shared library is compiled on demand with the system C compiler from
the repository's ``native/rle.c`` into ``build/native/`` (a directory that
``.gitignore`` lists); every entry point has a pure-numpy fallback, so
nothing depends on a toolchain at run time. This is host-side data loading,
not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(_NATIVE_DIR, "rle.c")
        so = os.path.join(_BUILD_DIR, "librle.so")
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                cc = os.environ.get("CC", "cc")
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-o", f"{so}.{os.getpid()}.tmp", src],
                    check=True,
                    capture_output=True,
                )
                os.replace(f"{so}.{os.getpid()}.tmp", so)
            lib = ctypes.CDLL(so)
            lib.rle_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.rle_decode.restype = ctypes.c_int
            _LIB = lib
        except Exception as e:  # no compiler / load failure -> numpy fallback
            print(f"[native] librle unavailable ({e}); using numpy fallback")
            _LIB = None
        return _LIB


def rle_decode_native(rle: dict) -> Optional[np.ndarray]:
    """Decode one COCO RLE dict via the C library; None if unavailable or
    the input uses uncompressed list counts."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple)):
        return None  # uncompressed: numpy path is already trivial
    lib = _build_and_load()
    if lib is None:
        return None
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    h, w = rle["size"]
    out = np.zeros(h * w, np.uint8)
    rc = lib.rle_decode(
        counts, len(counts), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise ValueError("malformed RLE input")
    return out.reshape(h, w)
