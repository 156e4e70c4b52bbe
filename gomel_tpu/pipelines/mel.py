"""High-level mel codec pipeline.

Equivalent of the reference ``Mel`` API
(/root/reference/mel/mel.go): host-side orchestration (audio files, PNG
codec, length math) around jitted device kernels (ops/mel_ops.py).

Reference method map:
- ToMel        -> Mel.to_mel / Mel.encode        (mel/mel.go:46-74)
- FromMel      -> Mel.from_mel / Mel.decode      (mel/mel.go:142-152)
- ToMelWav     -> Mel.to_mel_wav                 (mel/mel.go:194-209)
- ToMelFlac    -> Mel.to_mel_flac                (mel/mel.go:176-191)
- ToWavPng     -> Mel.to_wav_png                 (mel/mel.go:211-238)
- Image        -> Mel.image                      (mel/mel.go:171-173, impl.go:16-44)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import ConfigError, MelConfig
from ..core.filterbank import mel_weights, inverse_mel_weights
from ..core.framing import is_padded, pad_length
from ..io import audio as audio_io
from ..io import imagecodec
from ..ops.mel_ops import mel_encode, mel_decode
from ..ops.quantize import (dequantize_mel_plane, pcm16_encode,
                            pcm16_ingest, quantize_mel_plane)
from ..ops.stft import hann_window


class Mel:
    """Mel spectrogram codec (reference parity: /root/reference/mel/mel.go).

    Spectrogram layout: flattened [frames * num_mels, 2] float arrays at the
    public boundary (reference-compatible); use ``encode``/``decode`` for the
    natural [frames, num_mels, 2] device-array form.
    """

    def __init__(self, config: MelConfig | None = None, dtype=jnp.float32,
                 device_quantize: bool = False, **overrides):
        if config is None:
            config = MelConfig(**overrides)
        elif overrides:
            import dataclasses
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.dtype = dtype
        # device_quantize: fuse the PNG (de)quantizer into the device
        # programs (ops/quantize.py) — only uint8 planes + two extrema cross
        # the host boundary on file paths (8x less traffic than the float64
        # spectrogram). Opt-in: quantizes in f32 on device instead of f64 on
        # host; rare (~1e-5) one-step trunc boundary flips make the output
        # byte-near, not byte-identical, to the host quantizer (same policy
        # as Phase(device_quantize=True); tests/test_device_quantize_mel.py).
        self.device_quantize = device_quantize
        self._fwd = None
        self._inv = None
        self._window = None
        # per-instance jitted codecs CLOSE OVER the weight constants: the
        # filterbank bakes into the HLO instead of arriving as an argument
        # (the batch and sharded paths do the same). One trace per
        # program kind (and momentum value).
        self._fn_cache: dict = {}

    # -- cached device constants ------------------------------------------
    def _weights(self):
        if self._fwd is None:
            c = self.config
            self._fwd = jnp.asarray(
                mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax),
                dtype=self.dtype)
            self._inv = jnp.asarray(
                inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax),
                dtype=self.dtype)
        return self._fwd, self._inv

    def _win(self):
        if self._window is None:
            self._window = jnp.asarray(hann_window(self.config.resolut),
                                       dtype=self.dtype)
        return self._window

    def _encode_fn(self):
        key = ("enc",)
        if key not in self._fn_cache:
            c = self.config
            fwd, _ = self._weights()
            win = self._win()
            self._fn_cache[key] = jax.jit(lambda x: mel_encode(
                x, c.num_mels, c.resolut, c.window, fwd, win))
        return self._fn_cache[key]

    def _decode_fn(self, momentum):
        key = ("dec", float(momentum))
        if key not in self._fn_cache:
            c = self.config
            _, inv = self._weights()
            self._fn_cache[key] = jax.jit(lambda lm, k: mel_decode(
                lm, c.resolut, c.window, inv, c.griffin_lim_iterations, k,
                c.tune_mul, c.tune_add, None, momentum=float(momentum)))
        return self._fn_cache[key]

    def _encode_quantize_fn(self):
        # encode + PNG quantizer in ONE device program: only the uint8
        # planes and the two global extrema cross the host boundary
        key = ("encq",)
        if key not in self._fn_cache:
            c = self.config
            fwd, _ = self._weights()
            win = self._win()

            def fn(x):
                spec = mel_encode(x, c.num_mels, c.resolut, c.window, fwd,
                                  win)
                return quantize_mel_plane(spec, 255)
            self._fn_cache[key] = jax.jit(fn)
        return self._fn_cache[key]

    def _encode_quantize_pcm_fn(self, pad_to, scale=32768.0):
        # RAW PCM-16 variant: shared device prologue
        # (ops/quantize.pcm16_ingest — int16->float, mean, pad), then
        # encode + quantize; int16 upload halves the encode-side bytes
        key = ("encqp", pad_to, float(scale))
        if key not in self._fn_cache:
            c = self.config
            fwd, _ = self._weights()
            win = self._win()

            def fn(pcm):
                x = pcm16_ingest(pcm, self.dtype, scale, pad_to)
                spec = mel_encode(x, c.num_mels, c.resolut, c.window, fwd,
                                  win)
                return quantize_mel_plane(spec, 255)
            self._fn_cache[key] = jax.jit(fn)
        return self._fn_cache[key]

    def _dequantize_decode_fn(self, momentum, boost):
        # de-quantize + boost + Griffin-Lim decode in ONE device program:
        # only uint8 planes and the extrema are uploaded. VolumeBoost is
        # added to the LOG-domain values pre-decode exactly like the host
        # path (mel/mel.go:218-221).
        key = ("decq", float(momentum), float(boost))
        if key not in self._fn_cache:
            c = self.config
            _, inv = self._weights()

            def fn(img2, mx, mn, k):
                lm = dequantize_mel_plane(img2, mx, mn, 255)
                if boost != 0.0:
                    lm = lm + jnp.asarray(boost, lm.dtype)
                wave = mel_decode(lm, c.resolut, c.window, inv,
                                  c.griffin_lim_iterations, k,
                                  c.tune_mul, c.tune_add, None,
                                  momentum=float(momentum))
                # PCM-16 conversion on device (bit-identical to save_wav's
                # host conversion): int16 readback, half the float traffic
                return pcm16_encode(wave)
            self._fn_cache[key] = jax.jit(fn)
        return self._fn_cache[key]

    # -- device-level API ---------------------------------------------------
    def encode(self, x) -> jax.Array:
        """Padded-or-raw audio -> log-mel [F, num_mels, 2] (device array).

        Applies reference padding (mel/impl.go:429-455) host-side first.
        """
        x = np.asarray(x)
        if x.ndim != 1:
            # a [B, L] batch would silently pad to pad_length(B) — refuse
            raise ValueError(
                f"Mel.encode takes a single [L] signal (got shape "
                f"{x.shape}); use parallel.BatchedMel for [B, L] batches")
        padded = pad_length(len(x), self.config.window)
        if padded != len(x):
            x = np.pad(x, (0, padded - len(x)))
        return self._encode_fn()(jnp.asarray(x, dtype=self.dtype))

    def encode_quantized(self, x):
        """Audio -> (img2 [mels, F, 2] uint8, mgc_max, mgc_min): the encode
        program with the PNG quantizer fused in (device arrays;
        ops/quantize.quantize_mel_plane — GLOBAL min/max like the reference
        writer, mel/impl.go:138-152)."""
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError(
                f"Mel.encode_quantized takes a single [L] signal "
                f"(got shape {x.shape}); use parallel.BatchedMel for "
                f"[B, L] batches")
        padded = pad_length(len(x), self.config.window)
        if padded != len(x):
            x = np.pad(x, (0, padded - len(x)))
        return self._encode_quantize_fn()(jnp.asarray(x, dtype=self.dtype))

    def decode(self, logmel, seed: int = 0, momentum: float = 0.0) -> jax.Array:
        """log-mel [F, num_mels, 2] -> audio (device array), Griffin-Lim.

        The reference initializes Griffin-Lim from unseeded global rand
        (mel/mel.go:81-83); we use an explicit PRNG seed for reproducibility.
        ``momentum`` > 0 opts into the accelerated fast-Griffin-Lim update
        (ops/griffinlim.py) — same per-iteration cost, ~2-4x fewer
        iterations for equal spectral convergence; 0.0 is exact reference
        behavior.
        """
        c = self.config
        logmel = jnp.asarray(logmel, dtype=self.dtype)
        if logmel.ndim >= 2 and logmel.shape[-2] != c.num_mels:
            # Same footgun exists in the reference (NewMel defaults to 160
            # mels, mel/mel.go:32, while the CLI bakes 192,
            # cmd/tomel/main.go:28) — fail with the cause instead of a
            # shape error deep in the einsum.
            raise ConfigError(
                f"spectrogram has {logmel.shape[-2]} mel bins but "
                f"config.num_mels={c.num_mels}; decode with the same "
                f"config the image was written with (the CLI preset "
                f"MelConfig.cli_default() uses 192 mels, bare MelConfig() "
                f"uses the NewMel default 160)")
        key = jax.random.PRNGKey(seed)
        return self._decode_fn(momentum)(logmel, key)

    # -- reference-layout API ------------------------------------------------
    def to_mel(self, buf) -> np.ndarray:
        """Audio buffer -> flattened [F*num_mels, 2] float64 log-mel
        (reference ToMel, mel/mel.go:46-74)."""
        out = np.asarray(self.encode(buf), dtype=np.float64)
        return out.reshape(-1, 2)

    def from_mel(self, ospectrum, seed: int = 0,
                 momentum: float = 0.0) -> np.ndarray:
        """Flattened [F*num_mels, 2] log-mel -> audio float64
        (reference FromMel, mel/mel.go:142-152)."""
        spec = np.asarray(ospectrum, dtype=np.float64).reshape(
            -1, self.config.num_mels, 2)
        return np.asarray(self.decode(spec, seed=seed, momentum=momentum),
                          dtype=np.float64)

    def image(self, buf) -> np.ndarray:
        """In-memory uint16 image R | G<<8 with per-channel min/max
        (reference Image/dumpbuffer, mel/impl.go:16-44). Returns [F*num_mels]
        uint16 in the reference's y+x*mels order."""
        spec = np.asarray(buf, dtype=np.float64).reshape(
            -1, self.config.num_mels, 2)
        return imagecodec.dump_buffer_u16(spec)

    # -- file API -------------------------------------------------------------
    def _samples_in_mel(self, input_len: int, n_frames: int) -> float:
        # float64(len(buf)*NumMels)/float64(len(ospectrum)) with the flattened
        # spectrogram (mel/mel.go:188,206) == len(buf)/n_frames
        return float(input_len * self.config.num_mels) / float(
            n_frames * self.config.num_mels)

    def _to_mel_file(self, buf: np.ndarray, sr: int, output_file: str) -> None:
        if self.device_quantize:
            img2, mx, mn = self.encode_quantized(buf)
            img2 = np.asarray(img2)
            imagecodec.save_mel_image_quantized(
                output_file, img2, float(mx), float(mn),
                self.config.y_reverse,
                self._samples_in_mel(len(buf), img2.shape[1]), float(sr))
            return
        spec = np.asarray(self.encode(buf), dtype=np.float64)
        imagecodec.save_mel_image(
            output_file, spec, self.config.y_reverse,
            self._samples_in_mel(len(buf), spec.shape[0]), float(sr))

    def to_mel_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> mel PNG (reference ToMelWav, mel/mel.go:194-209)."""
        if self.device_quantize:
            buf, sr = audio_io.load_wav_any(input_file, mono="left",
                                            raw_pcm16=True)
            if buf.dtype == np.int16:
                pcm = buf
                c = self.config
                padded = pad_length(pcm.shape[0], c.window)
                fn = self._encode_quantize_pcm_fn(padded)
                img2, mx, mn = fn(jnp.asarray(pcm))
                img2 = np.asarray(img2)
                imagecodec.save_mel_image_quantized(
                    output_file, img2, float(mx), float(mn), c.y_reverse,
                    self._samples_in_mel(pcm.shape[0], img2.shape[1]),
                    float(sr))
                return
            self._to_mel_file(buf, sr, output_file)
            return
        buf, sr = audio_io.load_wav(input_file, mono="left")
        self._to_mel_file(buf, sr, output_file)

    def to_mel_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> mel PNG (reference ToMelFlac, mel/mel.go:176-191; note the
        mel package's 1/65536 FLAC scaling, mel/impl.go:290)."""
        if self.device_quantize:
            buf, sr = audio_io.load_flac_any(input_file, mono="go_concat",
                                             scaling="mel", raw_pcm16=True)
            if buf.dtype == np.int16:
                pcm = buf
                c = self.config
                padded = pad_length(pcm.shape[0], c.window)
                # mel FLAC scaling 1/65536 (mel/impl.go:290) — power of
                # two, exact on device
                fn = self._encode_quantize_pcm_fn(padded, scale=65536.0)
                img2, mx, mn = fn(jnp.asarray(pcm))
                img2 = np.asarray(img2)
                imagecodec.save_mel_image_quantized(
                    output_file, img2, float(mx), float(mn), c.y_reverse,
                    self._samples_in_mel(pcm.shape[0], img2.shape[1]),
                    float(sr))
                return
            self._to_mel_file(buf, sr, output_file)
            return
        buf, sr = audio_io.load_flac(input_file, mono="go_concat",
                                     scaling="mel")
        self._to_mel_file(buf, sr, output_file)

    def to_tensor(self, buf) -> "jax.Array":
        """Audio buffer -> device log-mel [F, num_mels, 2]: the ML-pipeline
        hook (generalizes the port's to_tensor_flac, phase.py:291-318, to the
        mel codec — file -> device array with no PNG round trip)."""
        return self.encode(buf)

    def to_tensor_wav(self, input_file: str) -> "jax.Array":
        """WAV file -> device log-mel [F, num_mels, 2]."""
        buf, _ = audio_io.load_wav(input_file, mono="left")
        return self.encode(buf)

    def to_tensor_flac(self, input_file: str) -> "jax.Array":
        """FLAC file -> device log-mel [F, num_mels, 2] (mel 1/65536
        scaling, mel/impl.go:290; go_concat channel handling so a stereo
        FLAC yields the SAME spectrogram content as the PNG path
        ``to_mel_flac``)."""
        buf, _ = audio_io.load_flac(input_file, mono="go_concat",
                                    scaling="mel")
        return self.encode(buf)

    def to_wav_png(self, input_file: str, output_file: str, seed: int = 0,
                   momentum: float = 0.0) -> int:
        """mel PNG -> WAV (reference ToWavPng, mel/mel.go:211-238).

        VolumeBoost is added to the LOG-domain values before decoding
        (mel/mel.go:218-221); output is trimmed via the padding detector and
        the embedded sample rate is used when none is configured. Returns the
        sample rate written. ``momentum`` > 0 opts into fast-GL
        (ops/griffinlim.py); 0.0 = exact reference behavior."""
        c = self.config
        if self.device_quantize:
            planes, mx, mn, samples, sr = imagecodec.load_mel_image_raw(
                input_file, c.y_reverse)
            if planes.shape[0] != c.num_mels:
                raise ConfigError(
                    f"spectrogram has {planes.shape[0]} mel bins but "
                    f"config.num_mels={c.num_mels}; decode with the same "
                    f"config the image was written with")
            fn = self._dequantize_decode_fn(momentum, c.volume_boost)
            pcm_dev, finite = fn(jnp.asarray(planes),
                                 jnp.asarray(mx, jnp.float32),
                                 jnp.asarray(mn, jnp.float32),
                                 jax.random.PRNGKey(seed))
            wave = np.asarray(pcm_dev)  # int16 readback: half the bytes
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            spec, samples, sr = imagecodec.load_mel_image(
                input_file, c.y_reverse)
            if c.volume_boost != 0.0:
                spec = spec + c.volume_boost
            wave = np.asarray(self.decode(spec, seed=seed, momentum=momentum),
                              dtype=np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave), self.config.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = self.config.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = int(sr)
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr
