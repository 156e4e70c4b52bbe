"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The suite runs on the CPU whatever accelerator the host has (the config is
set after import, like ``JAX_PLATFORMS=cpu``); GPU runs go through
``python chip_smoke.py``. Multi-device sharding tests run on the 8-device
virtual CPU mesh (``--xla_force_host_platform_device_count``), per
SURVEY.md §4.
"""
import os
import sys
import types

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REFERENCE_DIR = "/root/reference"


def _sf_read(path, dtype="float64"):
    """libsndfile-convention read for the soundfile stub: PCM16 -> value /
    32768.0 as float (what the real soundfile returns for dtype='float64')."""
    import numpy as np
    from gomel_tpu.io import wavcodec
    arr, sr = wavcodec.read_wav(path)
    if arr.dtype == np.int16:
        arr = arr.astype(np.float64) / 32768.0
    return arr.astype(dtype), sr


def _sf_write(path, data, samplerate, subtype="PCM_16"):
    """libsndfile-convention write for the stub (same rint-saturate int16
    conversion as gomel_tpu.io.audio.save_wav, so file-level differentials
    isolate the DSP orchestration, not quantizer rounding)."""
    import numpy as np
    from gomel_tpu.io import wavcodec
    data = np.asarray(data, dtype=np.float64)
    pcm = np.clip(np.rint(data * 32768.0), -32768, 32767).astype(np.int16)
    wavcodec.write_wav(path, pcm, int(samplerate))


def load_reference_phase():
    """Import the reference Python port (golden oracle) if present.

    The reference imports soundfile, which is absent here — stub it with
    read/write backed by the in-tree WAV codec so the port's FILE-level
    APIs (to_phase_wav / to_wav_png) run for differential fuzzing, not just
    the buffer-level ones.
    """
    if not os.path.isdir(REFERENCE_DIR):
        return None
    if "soundfile" not in sys.modules:
        sf = types.ModuleType("soundfile")
        sf.read = _sf_read
        sf.write = _sf_write
        sys.modules["soundfile"] = sf
    if "png" not in sys.modules:
        # the reference HDR path imports pypng; back it with our shim
        from gomel_tpu.compat import pypng
        sys.modules["png"] = pypng
    if REFERENCE_DIR not in sys.path:
        sys.path.insert(0, REFERENCE_DIR)
    # the reference directory exists: an import failure here is a real
    # regression (e.g. in the pypng shim), not a legitimate absence — raise
    # rather than silently skipping the entire golden-oracle suite
    import phase as reference_phase  # noqa: F401
    return reference_phase
