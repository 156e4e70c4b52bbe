"""Shared ctypes loader/builder for the native C++ helpers in
gomel_tpu/native/.

``NativeLib`` builds a shared object from source on first use with g++ (baked
into the image) and configures its symbol signatures; it returns None when
the toolchain or build fails, letting callers fall back to their pure-Python
paths (with a one-time warning — the fallbacks are correct but orders of
magnitude slower). The sources live INSIDE the package (shipped as
package-data), so pip-installed wheels build the native path exactly like a
dev checkout. One instance per helper (PNG filters here, FLAC in io/flac.py)
keeps the build/mtime/retry policy in a single place.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

_logger = logging.getLogger("gomel_tpu")
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")


_ALL: list["NativeLib"] = []


class NativeLib:
    """Lazy build-and-load of one native helper."""

    def __init__(self, src_name: str, so_name: str, configure):
        self._src = os.path.join(_NATIVE_DIR, src_name)
        self._so = os.path.join(_NATIVE_DIR, so_name)
        self._configure = configure
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False
        _ALL.append(self)

    @property
    def name(self) -> str:
        return os.path.basename(self._src)

    def get(self):
        """Return the loaded ctypes library, building if needed, or None."""
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            try:
                if not os.path.exists(self._so) or (
                    os.path.exists(self._src)
                    and os.path.getmtime(self._src) > os.path.getmtime(self._so)
                ):
                    if not os.path.exists(self._src):
                        raise FileNotFoundError(self._src)
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC",
                         "-o", self._so, self._src],
                        check=True, capture_output=True, timeout=120)
                lib = ctypes.CDLL(self._so)
                self._configure(lib)
                self._lib = lib
            except Exception as e:
                _logger.warning(
                    "native helper %s unavailable (%s: %s); falling back to "
                    "the pure-Python implementation — correct but orders of "
                    "magnitude slower", os.path.basename(self._src),
                    type(e).__name__, e)
                self._lib = None
            return self._lib


def _configure_pngfilter(lib):
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
    ]
    lib.png_filter_up.restype = None
    lib.png_filter_up.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long,
    ]


_pngfilter = NativeLib("pngfilter.cpp", "_pngfilter.so", _configure_pngfilter)


def get_lib():
    """PNG filter helper (pngcodec.py's fast path), or None."""
    return _pngfilter.get()


def native_status() -> dict[str, bool]:
    """Build and load every native helper; source name -> whether it loaded
    (False means its callers run the pure-Python fallback)."""
    from . import flac  # noqa: F401  (registers the FLAC helper)
    return {lib.name: lib.get() is not None for lib in _ALL}
