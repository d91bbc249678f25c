"""Native (C++) runtime components, loaded via ctypes.

The reference keeps its sequential host-side work in C++ (the audio DSP
``AudioBands.h``, decode loops in ``ReelExport.cpp``); this package holds
this rebuild's equivalents.  Libraries are built lazily with g++ into
``_build/`` on first use; every consumer has a pure-Python fallback so
the framework still works without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_CACHE: dict = {}


def _build(name: str) -> str:
    src = os.path.join(_DIR, f"{name}.cpp")
    out = os.path.join(_BUILD_DIR, f"_{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = out + ".tmp"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
        check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def load(name: str) -> Optional[ctypes.CDLL]:
    """Build (if stale) and load ``<name>.cpp`` as a shared library.

    Returns None when no toolchain is available; callers fall back to
    their pure-Python implementation.
    """
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        try:
            lib = ctypes.CDLL(_build(name))
        except (OSError, subprocess.CalledProcessError, FileNotFoundError):
            lib = None
        _CACHE[name] = lib
        return lib
