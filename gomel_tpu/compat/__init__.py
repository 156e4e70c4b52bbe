"""Compatibility layer: drop-in module surfaces of the reference APIs.

``gomel_tpu.compat.phase`` mirrors /root/reference/phase.py (the PyPI
``phase-spectrogram`` package, installed as the top-level module ``phase``)
so existing users can switch imports without code changes while compute runs
on the accelerator kernels. For code that does ``import phase`` / ``from phase import
Phase`` verbatim, call :func:`install` once at startup.
"""
import sys

from . import phase
from . import pypng


def install(register_pypng: bool = True) -> None:
    """Register the compat modules under the names the reference ecosystem
    imports: ``phase`` (the PyPI port's top-level module) and, optionally,
    ``png`` (pypng, used by the port's HDR path)."""
    sys.modules.setdefault("phase", phase)
    if register_pypng:
        sys.modules.setdefault("png", pypng)


__all__ = ["phase", "pypng", "install"]
