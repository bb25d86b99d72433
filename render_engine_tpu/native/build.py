"""Lazy g++ build + ctypes load for the native components.

No pybind11 in this environment, so the C ABI + ctypes is the binding
layer. Shared objects are cached next to the sources keyed by source
mtime; any failure (no compiler, sandboxed fs, bad toolchain) degrades to
the Python fallback silently — the native path is an accelerator, never a
requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE: dict = {}


def _so_path(name: str) -> str:
    return os.path.join(_DIR, f"_{name}.so")


def load(name: str):
    """Compile (if stale) and dlopen native/<name>.cpp; None on failure."""
    if os.environ.get("RE_NATIVE", "1") == "0":
        return None
    if name in _CACHE:
        return _CACHE[name]
    src = os.path.join(_DIR, f"{name}.cpp")
    so = _so_path(name)
    lib = None
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            proc = subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                 "-o", so + ".tmp", src],
                capture_output=True, text=True, timeout=120,
            )
            if proc.returncode != 0:
                raise RuntimeError(proc.stderr[-500:])
            os.replace(so + ".tmp", so)
        lib = ctypes.CDLL(so)
    except Exception:
        lib = None
    _CACHE[name] = lib
    return lib


def obj_native():
    """The OBJ parser library with argtypes set, or None."""
    lib = load("obj_loader")
    if lib is None:
        return None
    if not getattr(lib, "_re_tpu_typed", False):
        c = ctypes
        lib.obj_parse.restype = c.c_void_p
        lib.obj_parse.argtypes = [c.c_char_p]
        lib.obj_counts.restype = None
        lib.obj_counts.argtypes = [c.c_void_p] + [c.POINTER(c.c_int64)] * 2 \
            + [c.POINTER(c.c_int32)] * 2 + [c.POINTER(c.c_int64)] * 2
        lib.obj_copy.restype = None
        lib.obj_copy.argtypes = [
            c.c_void_p,
            c.POINTER(c.c_float), c.POINTER(c.c_float), c.POINTER(c.c_float),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.c_char_p, c.POINTER(c.c_int32), c.c_char_p,
        ]
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [c.c_void_p]
        lib._re_tpu_typed = True
    return lib
