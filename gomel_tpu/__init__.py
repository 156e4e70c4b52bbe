"""gomel_tpu — accelerator-native audio feature pipeline.

A from-scratch JAX/XLA framework with the capabilities of
neurlang/gomel (reference surveyed in SURVEY.md): mel-spectrogram and
phase-preserving spectrogram codecs, Griffin-Lim reconstruction, PNG
persistence with embedded float16 metadata, batched and multi-chip
data/frame-parallel execution.
"""

from .core.config import (
    ConfigError,
    FileNotLoadedError,
    GomelError,
    MelConfig,
    PhaseConfig,
    UnsupportedSampleRateError,
    num_freqs_for_sample_rate,
    pad_shift,
)
from .pipelines.mel import Mel
from .pipelines.phase import Phase
from .pipelines.longform import LongFormMel, LongFormPhase
from .pipelines.streaming import StreamingMel, StreamingPhase

__version__ = "0.1.0"

__all__ = [
    "Mel",
    "Phase",
    "LongFormMel",
    "LongFormPhase",
    "StreamingMel",
    "StreamingPhase",
    "MelConfig",
    "PhaseConfig",
    "GomelError",
    "FileNotLoadedError",
    "UnsupportedSampleRateError",
    "ConfigError",
    "num_freqs_for_sample_rate",
    "pad_shift",
    "__version__",
]
