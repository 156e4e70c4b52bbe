"""Configuration dataclasses for the mel and phase codecs.

Re-design of the reference config structs:
- ``Mel`` struct: /root/reference/mel/mel.go:10-41 (defaults NumMels=160, fmax=8000,
  Window=256, Resolut=2048, GriffinLimIterations=2).
- ``Phase`` struct: /root/reference/phase/phase.go:8-28 (defaults NumFreqs=768,
  Window=1280, Resolut=4096).
- Python port ctor and sample-rate validation: /root/reference/phase.py:19-61.

Terminology note (preserved from the reference, see SURVEY.md §5.1): ``window`` is the
HOP SIZE (gossp ``stft.New(frameShift, frameLen)`` passes Window as frameShift), and
``resolut`` is the analysis-window/FFT length. The Hann window applied to each frame
has length ``resolut``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Sample-rate families (reference: /root/reference/phase/impl.go:476-504 and
# /root/reference/phase.py:49-61). The 48 kHz family maps to 768 frequency bins,
# the 44.1 kHz family to 836 bins; HDR doubles both (phase.py:52-55).
FAMILY_48K = (8000, 16000, 24000, 32000, 48000)
FAMILY_44K = (11025, 22050, 44100)
SUPPORTED_SAMPLE_RATES = FAMILY_48K + FAMILY_44K

# Zero-stuffing upsample parameters per sample rate:
# (zero_pad, zero_shift) — keep `zero_pad` samples, insert `zero_shift` zeros
# (reference: /root/reference/phase/impl.go:476-504).
PAD_SHIFT_TABLE = {
    48000: (0, 0),
    32000: (2, 1),   # 1.5x
    24000: (1, 1),   # 2x
    16000: (1, 2),   # 3x
    8000: (1, 5),    # 6x
    44100: (0, 0),
    22050: (1, 1),   # 2x
    11025: (1, 3),   # 4x
}


class GomelError(Exception):
    """Base error for gomel_tpu."""


class FileNotLoadedError(GomelError):
    """Raised when an audio file cannot be loaded.

    Parity with the reference sentinel ``ErrFileNotLoaded``
    (/root/reference/mel/mel.go:43, /root/reference/phase/phase.go:38).
    """


class UnsupportedSampleRateError(GomelError, ValueError):
    """Raised for sample rates outside the two supported families
    (reference: /root/reference/phase.py:57-61)."""


class ConfigError(GomelError, ValueError):
    """Raised for invalid configuration values."""


def num_freqs_for_sample_rate(sample_rate: int, hdr: bool = False) -> int:
    """Frequency-bin count for a sample rate (reference: /root/reference/phase.py:49-61)."""
    if sample_rate in FAMILY_48K:
        base = 768
    elif sample_rate in FAMILY_44K:
        base = 836
    else:
        raise UnsupportedSampleRateError(
            f"Unsupported sample rate: {sample_rate}. "
            f"Supported rates are: {', '.join(str(r) for r in SUPPORTED_SAMPLE_RATES)}"
        )
    return base * 2 if hdr else base


def pad_shift(sample_rate: int) -> tuple[int, int]:
    """Zero-stuffing upsample parameters (reference: /root/reference/phase/impl.go:476-504).

    Unknown rates return (0, 0) like the Go fallthrough.
    """
    return PAD_SHIFT_TABLE.get(sample_rate, (0, 0))


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel-spectrogram codec configuration.

    Mirrors the reference ``Mel`` struct (/root/reference/mel/mel.go:10-27) with
    the defaults of ``NewMel`` (/root/reference/mel/mel.go:30-41).
    """

    num_mels: int = 160
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    tune_mul: float = 1.0
    tune_add: float = 0.0
    window: int = 256           # hop size (frameShift)
    resolut: int = 2048         # FFT length (frameLen)
    y_reverse: bool = False
    griffin_lim_iterations: int = 2
    volume_boost: float = 0.0
    sample_rate: int = 0

    def __post_init__(self):
        if self.window <= 0 or self.resolut <= 0:
            raise ConfigError("window and resolut must be positive")
        if self.resolut % 2 != 0:
            raise ConfigError("resolut must be even")
        if self.num_mels <= 0:
            raise ConfigError("num_mels must be positive")

    @property
    def n_bins(self) -> int:
        """Number of stored spectrum bins per frame (Resolut/2)."""
        return self.resolut // 2

    @classmethod
    def cli_default(cls, **overrides) -> "MelConfig":
        """Parameters baked into the reference CLIs
        (/root/reference/cmd/tomel/main.go:24-31, cmd/towav/main.go:28-38)."""
        base = dict(
            num_mels=192, mel_fmin=0.0, mel_fmax=16000.0, y_reverse=True,
            window=1280, resolut=4096, griffin_lim_iterations=2, volume_boost=0.0,
        )
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class PhaseConfig:
    """Phase-preserving spectrogram codec configuration.

    Mirrors the reference ``Phase`` struct (/root/reference/phase/phase.go:8-28)
    and the Python port's constructor (/root/reference/phase.py:19-61).
    """

    num_freqs: int = 768
    window: int = 1280          # hop size (frameShift)
    resolut: int = 4096         # FFT length (frameLen)
    y_reverse: bool = False
    sample_rate: int = 0
    volume_boost: float = 0.0
    ihs: bool = False
    hdr: bool = False

    def __post_init__(self):
        if self.window <= 0 or self.resolut <= 0:
            raise ConfigError("window and resolut must be positive")
        if self.resolut % 2 != 0:
            raise ConfigError("resolut must be even")
        if self.num_freqs <= 0 or self.num_freqs > self.resolut // 2:
            raise ConfigError("num_freqs must be in (0, resolut/2]")

    @property
    def n_bins(self) -> int:
        return self.resolut // 2

    @property
    def ihs_passes(self) -> int:
        """Number of asinh/sinh compression passes.

        2 when IHS is enabled on 8-bit output, 0 otherwise
        (reference: /root/reference/phase/phase.go:31-36, phase.py:41).
        """
        return 2 if (self.ihs and not self.hdr) else 0

    @property
    def family_main_rate(self) -> int:
        """Output WAV rate family derived from num_freqs
        (reference: /root/reference/phase/phase.go:262-270)."""
        if self.num_freqs in (836, 836 * 2):
            return 44100
        return 48000

    @classmethod
    def for_sample_rate(cls, sample_rate: int, **overrides) -> "PhaseConfig":
        """Python-port constructor behavior: derive num_freqs from the sample rate,
        HDR doubling included (reference: /root/reference/phase.py:49-61).

        NOTE: like the port (phase.py:20), this constructor defaults
        ``y_reverse=True`` — unlike the bare ``PhaseConfig()``, which keeps the
        Go ``NewPhase`` zero value (False). Every reference CLI also sets True.
        """
        hdr = bool(overrides.get("hdr", False))
        nf = num_freqs_for_sample_rate(sample_rate, hdr=hdr)
        kw = dict(num_freqs=nf, sample_rate=sample_rate, y_reverse=True)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def cli_default(cls, **overrides) -> "PhaseConfig":
        """Parameters baked into the reference CLIs
        (/root/reference/cmd/tophase/main.go:21-28, cmd/fromphase/main.go:22-28)."""
        base = dict(num_freqs=768 * 2, window=1280, resolut=4096, y_reverse=True,
                    volume_boost=0.0)
        base.update(overrides)
        return cls(**base)
