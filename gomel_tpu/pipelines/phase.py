"""High-level phase codec pipeline.

Equivalent of the reference ``Phase`` API
(/root/reference/phase/phase.go and the Python port /root/reference/phase.py).

Reference method map:
- ToPhase        -> Phase.to_phase / Phase.encode    (phase/phase.go:41-70)
- FromPhase      -> Phase.from_phase / Phase.decode  (phase/phase.go:136-153)
- ToPhaseWav     -> Phase.to_phase_wav               (phase/phase.go:221-244)
- ToPhaseFlac    -> Phase.to_phase_flac              (phase/phase.go:195-218)
- ToWavPng       -> Phase.to_wav_png                 (phase/phase.go:246-275)
- to_tensor_flac -> Phase.to_tensor_flac             (phase.py:291-318)

Behavioral switches where Go and the Python port disagree (SURVEY.md §5):
- ``metadata_layout``: "go" = 16-byte phase metadata (canonical), "py" = the
  port's incompatible 12-byte layout.
- ``length_mode``: the samples_in_mel numerator uses the PRE-upsample length in
  Go (phase/phase.go:202-215) but the POST-upsample length in the port
  (phase.py:239-249). "go" is the default.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import (PhaseConfig, num_freqs_for_sample_rate, pad_shift)
from ..core.framing import is_padded, pad_length
from ..io import audio as audio_io
from ..io import imagecodec
from ..ops.phase_ops import phase_encode, phase_decode
from ..ops.quantize import (dequantize_planes, pcm16_encode,
                            pcm16_ingest, quantize_planes)
from ..ops.resample import zero_stuff_upsample
from ..ops.stft import hann_window


# Encode jits close over the Hann window as a compile-time CONSTANT
# (numpy array, baked into the HLO) rather than taking it as a traced
# argument, like Mel's weights. Cached per
# (num_freqs, frame_len, hop[, max_val, ihs]) signature.
@functools.lru_cache(maxsize=64)
def _encode_jit_for(num_freqs, frame_len, hop, np_dtype):
    window = hann_window(frame_len).astype(np_dtype)
    return jax.jit(lambda x: phase_encode(x, num_freqs, frame_len, hop,
                                          window))


@functools.lru_cache(maxsize=64)
def _encode_quantize_jit_for(num_freqs, frame_len, hop, max_val,
                             ihs_passes, np_dtype):
    # encode + PNG quantizer in ONE device program: only the integer image
    # planes and two extrema pairs ever cross the host boundary
    window = hann_window(frame_len).astype(np_dtype)

    def fn(x):
        spec = phase_encode(x, num_freqs, frame_len, hop, window)
        return quantize_planes(spec, max_val, ihs_passes)
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _encode_quantize_pcm_jit_for(num_freqs, frame_len, hop,
                                 max_val, ihs_passes, np_dtype,
                                 zp, zs, pad_to, scale=32768.0):
    # the full file-encode program from RAW PCM-16: int16->float (exact:
    # /32768 is a power-of-two scale; a stereo mean sums exact f32
    # integers), zero-stuff upsample (ops/resample — jittable, static
    # shapes), reference padding, encode, PNG quantize. Upload is int16 —
    # half the float bytes — and upsampled rates upload the PRE-upsample
    # signal (up to 6x less for the 8 kHz family).
    window = hann_window(frame_len).astype(np_dtype)

    def fn(pcm):
        x = pcm16_ingest(pcm, np_dtype, scale, pad_to, zp, zs)
        spec = phase_encode(x, num_freqs, frame_len, hop, window)
        return quantize_planes(spec, max_val, ihs_passes)
    return jax.jit(fn)


@functools.partial(jax.jit, static_argnames=("frame_len", "hop",
                                             "volume_boost",
                                             "max_val", "ihs_passes"))
def _dequantize_decode_jit(img2, maxs, mins, frame_len, hop, volume_boost,
                           max_val, ihs_passes):
    # de-quantize + decode in ONE device program: only integer planes and
    # the extrema pairs are uploaded (ops/quantize.dequantize_planes)
    spec = dequantize_planes(img2, maxs, mins, max_val, ihs_passes)
    return phase_decode(spec, frame_len, hop, volume_boost, None)


@functools.partial(jax.jit, static_argnames=("frame_len", "hop",
                                             "volume_boost",
                                             "max_val", "ihs_passes"))
def _dequantize_decode_pcm_jit(img2, maxs, mins, frame_len, hop,
                               volume_boost, max_val, ihs_passes):
    # the file-decode program: dequantize + decode + PCM-16 conversion
    # (ops/quantize.pcm16_encode — bit-identical to save_wav's host
    # conversion) so the readback is int16, half the float traffic
    spec = dequantize_planes(img2, maxs, mins, max_val, ihs_passes)
    return pcm16_encode(phase_decode(spec, frame_len, hop, volume_boost,
                                     None))


@functools.partial(jax.jit,
                   static_argnames=("frame_len", "hop", "volume_boost"))
def _decode_jit(spec2, frame_len, hop, volume_boost):
    return phase_decode(spec2, frame_len, hop, volume_boost, None)


class Phase:
    """Phase-preserving spectrogram codec (reference parity:
    /root/reference/phase/phase.go, /root/reference/phase.py)."""

    def __init__(self, config: PhaseConfig | None = None, dtype=jnp.float32,
                 metadata_layout: str = "go", length_mode: str = "go",
                 sample_rate: int | None = None,
                 device_quantize: bool = False, **overrides):
        if config is None:
            if sample_rate is not None:
                config = PhaseConfig.for_sample_rate(sample_rate, **overrides)
            else:
                config = PhaseConfig(**overrides)
        elif overrides:
            import dataclasses
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.dtype = dtype
        self.metadata_layout = metadata_layout
        self.length_mode = length_mode
        # device_quantize: fuse the PNG quantizer into the encode program
        # (ops/quantize.py) — 4x less host<->device traffic on file writes.
        # Opt-in: quantizes in f32 on device instead of f64 on host; the
        # rare (<~1e-5 of pixels) one-step trunc boundary flips make the
        # output byte-near, not byte-identical, to the host quantizer.
        self.device_quantize = device_quantize

    def reconfigure_sr(self, sample_rate: int) -> None:
        """Re-derive num_freqs from a sample rate
        (reference: /root/reference/phase.py:49-61). Raises
        UnsupportedSampleRateError outside the two families."""
        import dataclasses
        nf = num_freqs_for_sample_rate(sample_rate, hdr=self.config.hdr)
        self.config = dataclasses.replace(
            self.config, num_freqs=nf, sample_rate=sample_rate)

    # -- device-level API ----------------------------------------------------
    def encode(self, x) -> jax.Array:
        """Audio -> phase spectrogram [F, num_freqs, 2] (device array); applies
        reference padding host-side (phase/impl.go:424-450)."""
        x = np.asarray(x)
        if x.ndim != 1:
            # a [B, L] batch would silently pad to pad_length(B) — refuse
            raise ValueError(
                f"Phase.encode takes a single [L] signal (got shape "
                f"{x.shape}); use parallel.BatchedPhase for [B, L] batches")
        padded = pad_length(len(x), self.config.window)
        if padded != len(x):
            x = np.pad(x, (0, padded - len(x)))
        c = self.config
        fn = _encode_jit_for(c.num_freqs, c.resolut, c.window,
                             np.dtype(self.dtype).name)
        return fn(jnp.asarray(x, dtype=self.dtype))

    def encode_quantized(self, x):
        """Audio -> (img2 [nf, F, 2] uint8|uint16, maxs [2], mins [2]):
        the encode program with the PNG quantizer fused in (device arrays;
        ops/quantize.quantize_planes). IHS/HDR follow the config."""
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError(
                f"Phase.encode_quantized takes a single [L] signal "
                f"(got shape {x.shape})")
        padded = pad_length(len(x), self.config.window)
        if padded != len(x):
            x = np.pad(x, (0, padded - len(x)))
        c = self.config
        fn = _encode_quantize_jit_for(
            c.num_freqs, c.resolut, c.window, 65535 if c.hdr else 255,
            c.ihs_passes, np.dtype(self.dtype).name)
        return fn(jnp.asarray(x, dtype=self.dtype))

    def decode(self, spec2) -> jax.Array:
        """Phase spectrogram [F, num_freqs, 2] -> audio (device array)."""
        c = self.config
        spec2 = jnp.asarray(spec2, dtype=self.dtype)
        return _decode_jit(spec2, c.resolut, c.window, float(c.volume_boost))

    def decode_quantized(self, planes, maxs, mins) -> jax.Array:
        """Integer PNG planes [nf, F, 2] + per-channel extrema -> audio: the
        fused dequantize (+sinh IHS undo) + VolumeBoost + decode program
        (ops/quantize.dequantize_planes). Only the integer planes and two
        extrema pairs are uploaded (imagecodec.load_phase_image_raw)."""
        c = self.config
        return _dequantize_decode_jit(
            jnp.asarray(planes), jnp.asarray(maxs, jnp.float32),
            jnp.asarray(mins, jnp.float32), c.resolut, c.window,
            float(c.volume_boost), 65535 if c.hdr else 255,
            c.ihs_passes)

    def decode_quantized_pcm16(self, planes, maxs, mins):
        """:meth:`decode_quantized` with the PCM-16 conversion fused in:
        returns (int16 PCM device array, all-finite flag). Bit-identical to
        converting the float result through io.audio.save_wav (*32768 is an
        exact power-of-two scale); the readback is half the bytes."""
        c = self.config
        return _dequantize_decode_pcm_jit(
            jnp.asarray(planes), jnp.asarray(maxs, jnp.float32),
            jnp.asarray(mins, jnp.float32), c.resolut, c.window,
            float(c.volume_boost), 65535 if c.hdr else 255,
            c.ihs_passes)

    # -- reference-layout API --------------------------------------------------
    def to_phase(self, buf) -> np.ndarray:
        """Audio -> flattened [F*num_freqs, 2] float64
        (reference ToPhase, phase/phase.go:41-70)."""
        return np.asarray(self.encode(buf), dtype=np.float64).reshape(-1, 2)

    def from_phase(self, ospectrum) -> np.ndarray:
        """Flattened [F*num_freqs, 2] -> audio float64
        (reference FromPhase, phase/phase.go:136-153)."""
        spec = np.asarray(ospectrum, dtype=np.float64).reshape(
            -1, self.config.num_freqs, 2)
        return np.asarray(self.decode(spec), dtype=np.float64)

    def image(self, buf) -> np.ndarray:
        """uint16 R|G<<8 preview image (reference Image/dumpbuffer,
        phase/impl.go:15-43)."""
        spec = np.asarray(buf, dtype=np.float64).reshape(
            -1, self.config.num_freqs, 2)
        return imagecodec.dump_buffer_u16(spec)

    # -- file API ----------------------------------------------------------------
    def _encode_file(self, buf: np.ndarray, sr: int, output_file: str,
                     update_sr_after_upsample: bool = False) -> None:
        original_pre = len(buf)
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            buf = zero_stuff_upsample(buf, zp, zs)
            if update_sr_after_upsample:
                # port behavior for FLAC: scale the recorded rate
                # (phase.py:274-275)
                sr = int(sr * len(buf) / original_pre)
        original = original_pre if self.length_mode == "go" else len(buf)
        if self.device_quantize:
            img2, maxs, mins = self.encode_quantized(buf)
            img2 = np.asarray(img2)
            n_frames = img2.shape[1]
        else:
            spec = np.asarray(self.encode(buf), dtype=np.float64)
            n_frames = spec.shape[0]
        # float64(originalLength*NumFreqs)/float64(len(ospectrum)) with the
        # flattened spectrogram (phase/phase.go:215,241) == original/n_frames
        samples_in_mel = float(original * self.config.num_freqs) / float(
            n_frames * self.config.num_freqs)
        if self.device_quantize:
            imagecodec.save_phase_image_quantized(
                output_file, img2, np.asarray(maxs), np.asarray(mins),
                self.config.y_reverse, samples_in_mel, float(sr),
                self.config.hdr, layout=self.metadata_layout)
        else:
            imagecodec.save_phase_image(
                output_file, spec, self.config.y_reverse, samples_in_mel,
                float(sr), self.config.ihs_passes, self.config.hdr,
                layout=self.metadata_layout)

    def _encode_file_pcm(self, pcm: np.ndarray, sr: int, output_file: str,
                         update_sr_after_upsample: bool = False,
                         scale: float = 32768.0) -> None:
        """Device-quantize file encode from RAW int16 PCM: the int16->float
        conversion, stereo mean, zero-stuff upsample, padding, encode and
        PNG quantize all run in ONE device program
        (_encode_quantize_pcm_jit_for) — bit-identical signal prep to the
        host path, half (or, for upsampled rates, up to 12x less) upload."""
        c = self.config
        original_pre = pcm.shape[0]
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            groups = (original_pre + zp - 1) // zp
            up_len = original_pre + groups * zs
            if update_sr_after_upsample:
                sr = int(sr * up_len / original_pre)
        else:
            up_len = original_pre
        original = original_pre if self.length_mode == "go" else up_len
        padded = pad_length(up_len, c.window)
        fn = _encode_quantize_pcm_jit_for(
            c.num_freqs, c.resolut, c.window, 65535 if c.hdr else 255,
            c.ihs_passes, np.dtype(self.dtype).name, zp, zs, padded,
            float(scale))
        img2, maxs, mins = fn(jnp.asarray(pcm))
        img2 = np.asarray(img2)
        samples_in_mel = float(original) / float(img2.shape[1])
        imagecodec.save_phase_image_quantized(
            output_file, img2, np.asarray(maxs), np.asarray(mins),
            c.y_reverse, samples_in_mel, float(sr), c.hdr,
            layout=self.metadata_layout)

    def to_phase_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> phase PNG with zero-stuff upsampling
        (reference ToPhaseWav, phase/phase.go:221-244)."""
        mono = "left" if self.metadata_layout == "go" else "mean"
        buf, sr = audio_io.load_wav_any(input_file, mono=mono,
                                        raw_pcm16=self.device_quantize)
        if self.config.sample_rate == 0 and self.metadata_layout == "py":
            self.reconfigure_sr(sr)
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file)
            return
        self._encode_file(buf, sr, output_file)

    def to_phase_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> phase PNG (reference ToPhaseFlac, phase/phase.go:195-218;
        phase FLAC scaling is 1/32768, phase/impl.go:375)."""
        mono = "go_concat" if self.metadata_layout == "go" else "mean"
        buf, sr = audio_io.load_flac_any(input_file, mono=mono,
                                         scaling="phase",
                                         raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            if self.config.sample_rate == 0 and self.metadata_layout == "py":
                self.reconfigure_sr(sr)
            self._encode_file_pcm(
                buf, sr, output_file,
                update_sr_after_upsample=(self.length_mode == "py"))
            return
        if self.config.sample_rate == 0 and self.metadata_layout == "py":
            self.reconfigure_sr(sr)
        self._encode_file(buf, sr, output_file,
                          update_sr_after_upsample=(self.length_mode == "py"))

    def to_tensor(self, buf, sr: int) -> jax.Array:
        """Audio buffer + rate -> device spectrogram [F, num_freqs, 2]: the
        generalization of the port's ML-pipeline hook (phase.py:291-318) —
        upsample + encode, no PNG round trip."""
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            buf = zero_stuff_upsample(np.asarray(buf), zp, zs)
        return self.encode(buf)

    def to_tensor_flac(self, input_file: str) -> np.ndarray:
        """FLAC -> flattened [F*num_freqs, 2] spectrogram
        (reference: phase.py:291-318)."""
        buf, sr = audio_io.load_flac(input_file, mono="mean", scaling="phase")
        if self.config.sample_rate == 0:
            self.reconfigure_sr(sr)
        return np.asarray(self.to_tensor(buf, sr),
                          dtype=np.float64).reshape(-1, 2)

    def to_wav_png(self, input_file: str, output_file: str,
                   layout: str = "auto") -> int:
        """phase PNG -> WAV (reference ToWavPng, phase/phase.go:246-275).

        Returns the sample rate written. Output rate is the family main rate
        (48000/44100) when the object has none configured. ``layout`` picks
        the metadata layout of the input image ("go"/"py"; "auto" detects —
        see imagecodec._detect_phase_layout)."""
        if self.device_quantize:
            planes, maxs, mins, samples, sr, nf = \
                imagecodec.load_phase_image_raw(
                    input_file, self.config.y_reverse, self.config.hdr,
                    layout=layout)
        else:
            spec, samples, sr, nf = imagecodec.load_phase_image(
                input_file, self.config.y_reverse, self.config.ihs_passes,
                self.config.hdr, layout=layout)
        if nf != self.config.num_freqs:
            # adopt the image's bin count (port behavior, phase.py:329)
            import dataclasses
            self.config = dataclasses.replace(self.config, num_freqs=nf)
        if self.device_quantize:
            pcm_dev, finite = self.decode_quantized_pcm16(planes, maxs, mins)
            wave = np.asarray(pcm_dev)  # int16 readback: half the bytes
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            wave = np.asarray(self.decode(spec), dtype=np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave), self.config.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = self.config.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = self.config.family_main_rate
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr
