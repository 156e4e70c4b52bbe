"""Long-form frame-sharded pipelines — user-facing API over parallel/sharded.

The reference processes arbitrarily long files on one CPU core in O(N)
(SURVEY.md §5); this is the multi-device equivalent: hour-scale audio is
frame-sharded across the mesh's 'frame' axis with one-analysis-window halo
exchange, composing with the 'data' batch axis. This module hides the
FrameShardPlan/padding/trim bookkeeping behind the same encode/decode shapes
as pipelines.mel / pipelines.phase.

Typical use::

    mesh = make_mesh(data=1, frame=8)
    lf = LongFormPhase(PhaseConfig.cli_default(), mesh)
    spec = lf.encode(batch_of_long_audio)   # [B, F, num_freqs, 2]
    wav = lf.decode(spec)                   # [B, out_len]
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import MelConfig, PhaseConfig, ConfigError, pad_shift
from ..core.filterbank import inverse_mel_weights, mel_weights
from ..core.framing import is_padded, num_frames, pad_length
from ..io import audio as audio_io
from ..io import imagecodec
from ..ops.griffinlim import griffin_lim_magnitudes as _gl_magnitudes
from ..ops.mel_ops import mel_to_linear as _mel_to_linear
from ..ops.quantize import (dequantize_raw, pcm16_encode,
                            quantize_mel_plane, quantize_planes)
from ..ops.resample import zero_stuff_upsample
from ..parallel import sharded as sh
from ..parallel.mesh import DATA_AXIS, FRAME_AXIS, host_to_global


@functools.partial(jax.jit, static_argnums=(1, 2))
def _trim_2d(a, b, n):
    """jitted [B, F/T] leading trims — legal on non-fully-addressable global
    arrays, where eager slicing is forbidden."""
    return a[:b, :n]


class _LongFormBase:
    """Shared plumbing. Multi-process model: REPLICATED host input — the
    frame axis cuts through every row, so each process passes the identical
    full batch (e.g. each read the same file) and contributes the shards its
    devices own (mesh.host_to_global). Results are global arrays; on a pod,
    read them per-shard (``.addressable_shards``) or via collectives."""

    def __init__(self, mesh: Mesh, window: int, resolut: int, dtype):
        self.mesh = mesh
        self.n_frame_shards = mesh.shape[FRAME_AXIS]
        self._hop = window
        self._frame_len = resolut
        self.dtype = dtype
        self._fn_cache: dict = {}
        self._multiproc = jax.process_count() > 1

    def _plan(self, n_samples: int) -> sh.FrameShardPlan:
        padded = pad_length(n_samples, self._hop)
        f = num_frames(padded, self._frame_len, self._hop)
        return sh.plan_frame_sharding(f, self._frame_len, self._hop,
                                      self.n_frame_shards)

    def _plan_for_frames(self, f: int) -> sh.FrameShardPlan:
        return sh.plan_frame_sharding(f, self._frame_len, self._hop,
                                      self.n_frame_shards)

    def _get(self, key, builder):
        if key not in self._fn_cache:
            self._fn_cache[key] = builder()
        return self._fn_cache[key]

    def _asarray(self, x):
        """Host numpy on multi-process meshes (prep must not stage on the
        local default device), jnp otherwise."""
        if self._multiproc:
            return np.asarray(x, dtype=self.dtype)
        return jnp.asarray(x, dtype=self.dtype)

    def _pad_batch(self, x):
        """Pad the batch dim to a multiple of the data-axis size (zero rows
        are sliced off by the caller via _true_b)."""
        n_data = self.mesh.shape[DATA_AXIS]
        b = x.shape[0]
        target = -(-b // n_data) * n_data
        if target != b:
            pad = ((0, target - b),) + ((0, 0),) * (x.ndim - 1)
            x = np.pad(x, pad) if isinstance(x, np.ndarray) else jnp.pad(x, pad)
        return x, b

    def _prep_signal(self, x, plan: sh.FrameShardPlan):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            raise ValueError(
                "encode expects a replicated host batch on multi-process "
                "meshes (every process passes the identical full signal)")
        x = self._asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        x, b = self._pad_batch(x)
        return self._put(sh.pad_signal_for_plan(x, plan),
                         P(DATA_AXIS, FRAME_AXIS)), b

    def _put(self, arr, spec: P):
        """Assemble the global sharded input (device_put on one process)."""
        return host_to_global(arr, self.mesh, spec)

    def _prep_frames(self, spec, plan: sh.FrameShardPlan):
        """Pad a [B, F, ...] spectrogram to (batch multiple, F_pad) and make
        it global. Accepts either a host array (replicated on every process)
        or a global jax.Array (e.g. the result of this object's encode on a
        pod) — the latter is padded under jit, never pulled to host."""
        if isinstance(spec, jax.Array) and not spec.is_fully_addressable:
            b = spec.shape[0]
            n_data = self.mesh.shape[DATA_AXIS]
            db = -(-b // n_data) * n_data - b
            df = plan.n_frames_padded - spec.shape[1]
            padfn = self._get(("padglobal", db, df, spec.ndim), lambda: (
                jax.jit(lambda a: jnp.pad(
                    a.astype(self.dtype),
                    ((0, db), (0, df)) + ((0, 0),) * (a.ndim - 2)))))
            return padfn(spec), b
        spec = self._asarray(spec)
        spec_p, b = self._pad_batch(sh.pad_frames_for_plan(spec, plan))
        return self._put(spec_p, P(DATA_AXIS, FRAME_AXIS, None, None)), b

    def _trim(self, result, b: int, n: int):
        if self._multiproc:
            return _trim_2d(result, b, n)
        return result[:b, :n]

    def _prep_signal_raw(self, pcm, plan: sh.FrameShardPlan):
        """Int16 variant of _prep_signal (the raw-PCM ingest): pads and
        shards WITHOUT the float cast — a sharded elementwise conversion
        jit turns it into floats on device (exact: power-of-two scales)."""
        x = np.asarray(pcm)
        if x.ndim == 1:
            x = x[None, :]
        x, b = self._pad_batch(x)
        return self._put(sh.pad_signal_for_plan(x, plan),
                         P(DATA_AXIS, FRAME_AXIS)), b

    def _pcm_convert(self, scale: float):
        recip = float(1.0 / scale)
        return self._get(("pcmconv", float(scale)), lambda: jax.jit(
            lambda i: i.astype(self.dtype) * recip))

    def _require_single_controller(self, what: str) -> None:
        """The file APIs read/write one host file — they need the whole
        array addressable from this process (single controller; incl. the
        virtual multi-device CPU mesh). On a real pod, orchestrate encode/
        decode buffer-level + per-shard I/O instead
        (examples/pod_longform_resume.py)."""
        if self._multiproc:
            raise ValueError(
                f"{what} assembles the full file on one host; on "
                f"multi-process meshes use the buffer-level encode/decode "
                f"with per-shard I/O (docs/MULTIHOST.md)")


class LongFormPhase(_LongFormBase):
    """Frame-sharded phase codec for long audio (parity target:
    /root/reference/phase/phase.go buffer APIs, scaled out)."""

    def __init__(self, config: PhaseConfig | None = None,
                 mesh: Mesh | None = None, dtype=jnp.float32,
                 device_quantize: bool = False):
        if mesh is None:
            raise ValueError("LongFormPhase requires a mesh")
        self.config = config or PhaseConfig()
        # device_quantize: fuse the PNG (de)quantizer into the sharded
        # programs on the file paths — the extrema reductions ride the mesh
        # collectives and only integer planes cross the host boundary
        # (the hour-scale spectrogram is the dominant transfer)
        self.device_quantize = device_quantize
        super().__init__(mesh, self.config.window, self.config.resolut, dtype)

    def encode(self, x) -> jax.Array:
        """[B, L] (or [L]) -> [B, F, num_freqs, 2] (F = real frame count)."""
        n = np.asarray(x).shape[-1]
        plan = self._plan(n)
        fn = self._get(("enc", plan.n_frames_padded, plan.n_frames), lambda: (
            sh.sharded_phase_encode_fn(self.mesh, plan,
                                       self.config.num_freqs, self.dtype)))
        xp, b = self._prep_signal(x, plan)
        return self._trim(fn(xp), b, plan.n_frames)

    def decode(self, spec) -> jax.Array:
        """[B, F, num_freqs, 2] -> [B, out_len]."""
        if not hasattr(spec, "shape"):
            spec = np.asarray(spec)
        plan = self._plan_for_frames(spec.shape[1])
        fn = self._get(("dec", plan.n_frames_padded, plan.n_frames,
                        float(self.config.volume_boost)), lambda: (
            sh.sharded_phase_decode_fn(self.mesh, plan,
                                       float(self.config.volume_boost),
                                       self.dtype)))
        spec_p, b = self._prep_frames(spec, plan)
        return self._trim(fn(spec_p), b, plan.out_len)

    # -- file API (hour-scale equivalent of pipelines.phase.Phase;
    #    reference surface: /root/reference/phase/phase.go:195-275) --------
    def _write_spec(self, spec, original: int, sr: int,
                    output_file: str) -> None:
        """Quantize (device) or pull (host) the encoded [1, F, nf, 2]
        global spectrogram and write the PNG."""
        c = self.config
        n_frames = spec.shape[1]
        samples_in_mel = float(original) / float(n_frames)
        if self.device_quantize:
            qfn = self._get(("quant", n_frames), lambda: jax.jit(
                lambda s: quantize_planes(s[0], 65535 if c.hdr else 255,
                                          c.ihs_passes)))
            img2, maxs, mins = qfn(spec)
            imagecodec.save_phase_image_quantized(
                output_file, np.asarray(img2), np.asarray(maxs),
                np.asarray(mins), c.y_reverse, samples_in_mel, float(sr),
                c.hdr, layout="go")
            return
        imagecodec.save_phase_image(
            output_file, np.asarray(spec[0], dtype=np.float64), c.y_reverse,
            samples_in_mel, float(sr), c.ihs_passes, c.hdr, layout="go")

    def _encode_file(self, buf: np.ndarray, sr: int,
                     output_file: str) -> None:
        self._require_single_controller("LongFormPhase file encode")
        original = len(buf)  # Go samples_in_mel numerator: PRE-upsample
        zp, zs = pad_shift(int(sr))
        if zp > 0:
            buf = np.asarray(zero_stuff_upsample(buf, zp, zs))
        spec = self.encode(buf)  # [1, F, nf, 2] global, sharded encode
        self._write_spec(spec, original, sr, output_file)

    def _encode_file_pcm(self, pcm: np.ndarray, sr: int,
                         output_file: str) -> None:
        """zp=0 raw int16 ingest: upload int16 (half the hour-scale
        bytes), convert sharded on device, then the standard sharded
        encode."""
        self._require_single_controller("LongFormPhase file encode")
        plan = self._plan(len(pcm))
        xg, b = self._prep_signal_raw(pcm, plan)
        xf = self._pcm_convert(32768.0)(xg)
        fn = self._get(("enc", plan.n_frames_padded, plan.n_frames),
                       lambda: sh.sharded_phase_encode_fn(
                           self.mesh, plan, self.config.num_freqs,
                           self.dtype))
        spec = self._trim(fn(xf), b, plan.n_frames)
        self._write_spec(spec, len(pcm), sr, output_file)

    def to_phase_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> phase PNG, frame-sharded over the mesh (same file
        orchestration as pipelines.phase.Phase.to_phase_wav — upsample,
        samples_in_mel, Go metadata layout; phase/phase.go:221-244)."""
        buf, sr = audio_io.load_wav_any(input_file, mono="left",
                                        raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            if pad_shift(int(sr))[0] == 0:
                self._encode_file_pcm(buf, sr, output_file)
                return
            # upsampled family: convert IN MEMORY (= _to_float), no
            # second file decode
            buf = buf.astype(np.float64) / 32768.0
        self._encode_file(buf, sr, output_file)

    def to_phase_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> phase PNG, frame-sharded (phase/phase.go:195-218;
        1/32768 scaling)."""
        buf, sr = audio_io.load_flac_any(input_file, mono="go_concat",
                                         scaling="phase",
                                         raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            if pad_shift(int(sr))[0] == 0:
                self._encode_file_pcm(buf, sr, output_file)
                return
            buf = buf.astype(np.float64) / 32768.0
        self._encode_file(buf, sr, output_file)

    def to_wav_png(self, input_file: str, output_file: str,
                   layout: str = "auto") -> int:
        """phase PNG -> WAV, frame-sharded decode
        (phase/phase.go:246-275). Returns the sample rate written."""
        self._require_single_controller("LongFormPhase file decode")
        c = self.config
        if self.device_quantize:
            planes, maxs, mins, samples, sr, nf = \
                imagecodec.load_phase_image_raw(input_file, c.y_reverse,
                                                c.hdr, layout=layout)
            if nf != c.num_freqs:
                import dataclasses
                self.config = c = dataclasses.replace(c, num_freqs=nf)
            # the plan derives from the TRUE frame count (the sharded
            # decoder's real-frame mask depends on it); integer planes are
            # padded/sharded on frames and de-quantized (+sinh undo) on
            # device — pure elementwise on the [B, F, nf, 2] layout, the
            # extrema broadcast over the trailing channel axis (same math
            # as ops/quantize.dequantize_planes)
            plan = self._plan_for_frames(planes.shape[1])
            planes_p, b = self._pad_batch(sh.pad_frames_for_plan(
                planes.transpose(1, 0, 2)[None], plan))
            planes_g = self._put(planes_p,
                                 P(DATA_AXIS, FRAME_AXIS, None, None))
            max_val = 65535 if c.hdr else 255
            deq = self._get(("deq", plan.n_frames_padded), lambda: jax.jit(
                lambda i, mx, mn: dequantize_raw(
                    i, mx, mn, max_val, c.ihs_passes, dtype=self.dtype)))
            spec_g = deq(planes_g, jnp.asarray(maxs, jnp.float32),
                         jnp.asarray(mins, jnp.float32))
            fn = self._get(("dec", plan.n_frames_padded, plan.n_frames,
                            float(c.volume_boost)), lambda: (
                sh.sharded_phase_decode_fn(self.mesh, plan,
                                           float(c.volume_boost),
                                           self.dtype)))
            # PCM-16 conversion on device (bit-identical to save_wav's):
            # the hour-scale waveform reads back at half the bytes
            pcm_fn = self._get(("pcm16",), lambda: jax.jit(pcm16_encode))
            pcm_g, finite = pcm_fn(self._trim(fn(spec_g), b,
                                              plan.out_len)[0])
            wave = np.asarray(pcm_g)
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            spec, samples, sr, nf = imagecodec.load_phase_image(
                input_file, c.y_reverse, c.ihs_passes, c.hdr, layout=layout)
            if nf != c.num_freqs:
                import dataclasses
                self.config = c = dataclasses.replace(c, num_freqs=nf)
            wave = np.asarray(self.decode(spec[None])[0], dtype=np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave), c.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = c.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = c.family_main_rate
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr


class LongFormMel(_LongFormBase):
    """Frame-sharded mel codec with sharded Griffin-Lim (parity target:
    /root/reference/mel/mel.go buffer APIs, scaled out)."""

    def __init__(self, config: MelConfig | None = None,
                 mesh: Mesh | None = None, dtype=jnp.float32,
                 device_quantize: bool = False):
        if mesh is None:
            raise ValueError("LongFormMel requires a mesh")
        self.config = config or MelConfig()
        # see LongFormPhase.device_quantize
        self.device_quantize = device_quantize
        super().__init__(mesh, self.config.window, self.config.resolut, dtype)
        c = self.config
        self._fwd = mel_weights(c.n_bins, c.num_mels, c.mel_fmin, c.mel_fmax)
        self._inv = inverse_mel_weights(c.n_bins, c.num_mels, c.mel_fmin,
                                        c.mel_fmax)

    def encode(self, x) -> jax.Array:
        """[B, L] (or [L]) -> [B, F, num_mels, 2] log-mel."""
        n = np.asarray(x).shape[-1]
        plan = self._plan(n)
        fn = self._get(("enc", plan.n_frames_padded, plan.n_frames), lambda: (
            sh.sharded_mel_encode_fn(self.mesh, plan, self.config.num_mels,
                                     self._fwd, self.dtype)))
        xp, b = self._prep_signal(x, plan)
        return self._trim(fn(xp), b, plan.n_frames)

    def decode(self, logmel, seed: int = 0,
               momentum: float = 0.0) -> jax.Array:
        """[B, F, num_mels, 2] -> [B, out_len] via sharded Griffin-Lim.

        ``momentum`` > 0 opts into fast-GL (ops/griffinlim.py): ~2-4x fewer
        iterations for equal convergence at no per-iteration cost — the
        preferred setting for the long-form GL-64 class of workloads.
        """
        if not hasattr(logmel, "shape"):
            logmel = np.asarray(logmel)
        plan = self._plan_for_frames(logmel.shape[1])
        c = self.config
        fn = self._get(("dec", plan.n_frames_padded, plan.n_frames,
                        c.griffin_lim_iterations, momentum), lambda: (
            sh.sharded_mel_decode_fn(self.mesh, plan, self._inv,
                                     c.griffin_lim_iterations,
                                     c.tune_mul, c.tune_add, self.dtype,
                                     momentum=momentum)))
        logmel_p, b = self._prep_frames(logmel, plan)
        # key as a host value: every process passes the same seed (SPMD)
        key = np.asarray(jax.random.PRNGKey(seed))
        return self._trim(fn(logmel_p, key), b, plan.out_len)

    # -- file API (hour-scale equivalent of pipelines.mel.Mel;
    #    reference surface: /root/reference/mel/mel.go:176-238) ------------
    def _samples_in_mel(self, input_len: int, n_frames: int) -> float:
        return float(input_len) / float(n_frames)  # mel/mel.go:188,206

    def _write_spec(self, spec, input_len: int, sr: int,
                    output_file: str) -> None:
        c = self.config
        n_frames = spec.shape[1]
        if self.device_quantize:
            qfn = self._get(("quant", n_frames), lambda: jax.jit(
                lambda s: quantize_mel_plane(s[0], 255)))
            img2, mx, mn = qfn(spec)
            imagecodec.save_mel_image_quantized(
                output_file, np.asarray(img2), float(mx), float(mn),
                c.y_reverse, self._samples_in_mel(input_len, n_frames),
                float(sr))
            return
        imagecodec.save_mel_image(
            output_file, np.asarray(spec[0], dtype=np.float64), c.y_reverse,
            self._samples_in_mel(input_len, n_frames), float(sr))

    def _encode_file(self, buf: np.ndarray, sr: int,
                     output_file: str) -> None:
        self._require_single_controller("LongFormMel file encode")
        spec = self.encode(buf)  # [1, F, mels, 2] global, sharded encode
        self._write_spec(spec, len(buf), sr, output_file)

    def _encode_file_pcm(self, pcm: np.ndarray, sr: int, output_file: str,
                         scale: float) -> None:
        """Raw int16 ingest (see LongFormPhase._encode_file_pcm); mel has
        no upsample, so every 16-bit file qualifies. ``scale``: 32768 for
        WAV, 65536 for mel-scaled FLAC."""
        self._require_single_controller("LongFormMel file encode")
        plan = self._plan(len(pcm))
        xg, b = self._prep_signal_raw(pcm, plan)
        xf = self._pcm_convert(scale)(xg)
        fn = self._get(("enc", plan.n_frames_padded, plan.n_frames),
                       lambda: sh.sharded_mel_encode_fn(
                           self.mesh, plan, self.config.num_mels,
                           self._fwd, self.dtype))
        spec = self._trim(fn(xf), b, plan.n_frames)
        self._write_spec(spec, len(pcm), sr, output_file)

    def to_mel_wav(self, input_file: str, output_file: str) -> None:
        """WAV -> mel PNG, frame-sharded over the mesh (same orchestration
        as pipelines.mel.Mel.to_mel_wav; mel/mel.go:194-209)."""
        buf, sr = audio_io.load_wav_any(input_file, mono="left",
                                        raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file, 32768.0)
            return
        self._encode_file(buf, sr, output_file)

    def to_mel_flac(self, input_file: str, output_file: str) -> None:
        """FLAC -> mel PNG, frame-sharded (mel/mel.go:176-191; mel 1/65536
        FLAC scaling)."""
        buf, sr = audio_io.load_flac_any(input_file, mono="go_concat",
                                         scaling="mel",
                                         raw_pcm16=self.device_quantize)
        if buf.dtype == np.int16:
            self._encode_file_pcm(buf, sr, output_file, 65536.0)
            return
        self._encode_file(buf, sr, output_file)

    def to_wav_png(self, input_file: str, output_file: str, seed: int = 0,
                   momentum: float = 0.0) -> int:
        """mel PNG -> WAV via the frame-sharded Griffin-Lim decoder
        (mel/mel.go:211-238). VolumeBoost is added in the log domain
        pre-decode; trim + embedded-sample-rate rules match the single-chip
        path. Returns the sample rate written."""
        self._require_single_controller("LongFormMel file decode")
        c = self.config
        if self.device_quantize:
            planes, mx, mn, samples, sr = imagecodec.load_mel_image_raw(
                input_file, c.y_reverse)
            if planes.shape[0] != c.num_mels:
                raise ConfigError(
                    f"spectrogram has {planes.shape[0]} mel bins but "
                    f"config.num_mels={c.num_mels}; decode with the same "
                    f"config the image was written with")
            # true-frame plan (see LongFormPhase.to_wav_png): pad + shard
            # the integer planes, de-quantize + boost sharded on device,
            # then run the sharded GL decoder built on the SAME plan
            plan = self._plan_for_frames(planes.shape[1])
            planes_p, b = self._pad_batch(sh.pad_frames_for_plan(
                planes.transpose(1, 0, 2)[None], plan))
            planes_g = self._put(planes_p,
                                 P(DATA_AXIS, FRAME_AXIS, None, None))
            boost = float(c.volume_boost)
            deq = self._get(("deq", plan.n_frames_padded, boost),
                            lambda: jax.jit(
                lambda i, mxv, mnv: dequantize_raw(
                    i, mxv, mnv, 255, 0, boost, self.dtype)))
            logmel_g = deq(planes_g, jnp.asarray(mx, jnp.float32),
                           jnp.asarray(mn, jnp.float32))
            fn = self._get(("dec", plan.n_frames_padded, plan.n_frames,
                            c.griffin_lim_iterations, momentum), lambda: (
                sh.sharded_mel_decode_fn(self.mesh, plan, self._inv,
                                         c.griffin_lim_iterations,
                                         c.tune_mul, c.tune_add, self.dtype,
                                         momentum=momentum)))
            key = np.asarray(jax.random.PRNGKey(seed))
            pcm_fn = self._get(("pcm16",), lambda: jax.jit(pcm16_encode))
            pcm_g, finite = pcm_fn(self._trim(fn(logmel_g, key), b,
                                              plan.out_len)[0])
            wave = np.asarray(pcm_g)  # int16 readback: half the bytes
            if not bool(finite):
                raise ValueError("audio contains NaN/Inf samples")
        else:
            spec, samples, sr = imagecodec.load_mel_image(
                input_file, c.y_reverse)
            if spec.shape[1] != c.num_mels:
                raise ConfigError(
                    f"spectrogram has {spec.shape[1]} mel bins but "
                    f"config.num_mels={c.num_mels}; decode with the same "
                    f"config the image was written with")
            if c.volume_boost != 0.0:
                spec = spec + c.volume_boost
            wave = np.asarray(self.decode(spec[None], seed=seed,
                                          momentum=momentum)[0],
                              dtype=np.float64)
        samples_i = int(samples)
        if samples_i > 0 and is_padded(samples_i, len(wave), c.window) \
                and len(wave) > samples_i:
            wave = wave[:samples_i]
        out_sr = c.sample_rate
        if sr != 0 and out_sr == 0:
            out_sr = int(sr)
        if self.device_quantize:
            audio_io.save_wav_pcm16(output_file, wave, out_sr)
        else:
            audio_io.save_wav(output_file, wave, out_sr)
        return out_sr

    # -- resumable decode -----------------------------------------------------

    def decode_resumable(self, logmel, seed: int = 0, momentum: float = 0.0,
                         segment_iters: int = 8, callback=None,
                         resume: tuple[int, object] | None = None
                         ) -> jax.Array:
        """``decode`` split into preemption-safe segments — checkpoint/resume
        for the hour-scale GL-64 class of workloads (SURVEY.md §5: the
        reference's only persistence is the PNG itself; a pod job needs to
        survive restarts mid-Griffin-Lim).

        Runs ``segment_iters`` GL iterations per device call; after each
        segment ``callback(done_iters, carry)`` may persist the signal carry
        (``save_gl_checkpoint``), and ``resume=(done_iters, carry)`` restarts
        from one. With ``momentum == 0`` the segmented run executes the
        IDENTICAL iteration sequence as ``decode`` (all interior iterations
        reduced-precision, only the very last inverse exact) — bit-for-bit
        equal output, pinned by tests/test_longform.py. With momentum the
        extrapolation restarts at segment boundaries (slightly weaker
        acceleration; any init/trajectory is parity-valid, mel/mel.go:81-83).
        """
        if segment_iters < 1:
            raise ValueError("segment_iters must be >= 1")
        if not hasattr(logmel, "shape"):
            logmel = np.asarray(logmel)
        plan = self._plan_for_frames(logmel.shape[1])
        c = self.config
        total = c.griffin_lim_iterations
        logmel_p, b = self._prep_frames(logmel, plan)
        prep = self._get(("prep", plan.n_frames_padded), lambda: jax.jit(
            lambda lm: jax.vmap(_gl_magnitudes)(jax.vmap(
                lambda s: _mel_to_linear(s, jnp.asarray(self._inv,
                                                        self.dtype),
                                         c.tune_mul, c.tune_add))(
                lm.astype(self.dtype)))))
        mag = prep(logmel_p)
        batch = logmel_p.shape[0]
        if resume is None:
            noise = self._get(("noise", plan.n_frames_padded, batch),
                              lambda: sh.sharded_gl_noise_fn(
                                  self.mesh, plan, batch, self.dtype))
            sig = noise(np.asarray(jax.random.PRNGKey(seed)))
            done = 0
        else:
            done, sig = resume
            if not isinstance(sig, jax.Array):
                sig = self._put(np.asarray(sig, dtype=self.dtype),
                                P(DATA_AXIS, FRAME_AXIS))
        while done < total:
            step = min(segment_iters, total - done)
            last = done + step == total
            # key must include plan.n_frames: two inputs with different real
            # frame counts can pad to the same n_frames_padded but need
            # different real-frame masks
            gl = self._get(("glseg", plan.n_frames_padded, plan.n_frames,
                            step, last, momentum),
                           lambda: sh.sharded_griffin_lim_fn(
                self.mesh, plan, step, self.dtype, momentum=momentum,
                final_iteration=last))
            sig = gl(mag, sig)
            done += step
            if callback is not None:
                callback(done, sig)
        return self._trim(sig, b, plan.out_len)


# ---------------------------------------------------------------------------
# Checkpoint persistence for decode_resumable
# ---------------------------------------------------------------------------

def save_gl_checkpoint(path: str, done: int, carry) -> None:
    """Persist a ``decode_resumable`` checkpoint (iteration count + signal
    carry) to ``path`` (.npz). Single-process meshes only: on a pod each
    process sees only its own shards — persist
    ``carry.addressable_shards`` per process from the callback instead."""
    if jax.process_count() > 1:
        raise ValueError(
            "save_gl_checkpoint needs the full carry on one host; on "
            "multi-process meshes persist carry.addressable_shards per "
            "process from the decode_resumable callback")
    with open(path, "wb") as f:
        np.savez(f, done=int(done), carry=np.asarray(carry))


def load_gl_checkpoint(path: str) -> tuple[int, np.ndarray]:
    """Load a checkpoint written by :func:`save_gl_checkpoint`; pass the
    result as ``decode_resumable(..., resume=...)``."""
    with open(path, "rb") as f:
        z = np.load(f)
        return int(z["done"]), z["carry"]


# -- multi-process (pod) checkpointing: each process persists its shards ----

def _index_key(index, shape) -> str:
    """Canonical string for a shard's global slice (device-id independent,
    stable across restarts)."""
    parts = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}-{stop}")
    return "_".join(parts)


def save_gl_checkpoint_sharded(ckpt_dir: str, done: int, carry) -> None:
    """Pod-capable checkpoint: every process writes the shards its devices
    own (one .npz per distinct global slice) — the elastic-recovery half of
    ``decode_resumable`` on multi-process meshes, where no single host holds
    the full carry.

    Checkpoint-atomic layout: each iteration count gets its OWN
    ``iter_<done>/`` subdirectory; a process publishes its per-process
    ``COMPLETE.p<rank>`` marker only AFTER all its shard files landed, and
    every shard file embeds ``done``. A preemption mid-save leaves a
    partial subdirectory that :func:`load_gl_checkpoint_sharded` simply
    skips (the previous complete checkpoint survives untouched), and a
    mixed-iteration reassembly is impossible — shard stamps are validated
    at load. Files are keyed by the shard's GLOBAL slice, not device ids,
    so a restarted job with the same mesh shape reassembles them regardless
    of device enumeration details. Safe on a single process too.
    """
    import os
    shape = carry.shape
    sub = os.path.join(ckpt_dir, f"iter_{int(done):08d}")
    os.makedirs(sub, exist_ok=True)
    pid = jax.process_index()
    for s in carry.addressable_shards:
        fname = os.path.join(sub, f"shard_{_index_key(s.index, shape)}.npz")
        tmp = fname + f".tmp{pid}"
        with open(tmp, "wb") as f:
            np.savez(f, data=np.asarray(s.data), done=int(done))
        os.replace(tmp, fname)  # atomic per-file publish
    # META is identical from every process (idempotent, no cross-host
    # ordering or shared-filesystem requirement)
    meta = os.path.join(sub, "META.npz")
    tmp = meta + f".tmp{pid}"
    with open(tmp, "wb") as f:
        np.savez(f, done=int(done), shape=np.asarray(shape),
                 dtype=str(carry.dtype))
    os.replace(tmp, meta)
    # completeness marker LAST: this process's shards are all in place
    with open(os.path.join(sub, f"COMPLETE.p{pid}"), "w"):
        pass


def _complete_checkpoints(ckpt_dir: str) -> list[int]:
    """Iteration counts with META + this process's completeness marker."""
    import os
    pid = jax.process_index()
    out = []
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return out
    for name in names:
        if not name.startswith("iter_"):
            continue
        sub = os.path.join(ckpt_dir, name)
        if (os.path.exists(os.path.join(sub, f"COMPLETE.p{pid}"))
                and os.path.exists(os.path.join(sub, "META.npz"))):
            out.append(int(name[5:]))
    return sorted(out)


def prune_gl_checkpoints(ckpt_dir: str, keep_last: int = 2) -> None:
    """Drop old checkpoint iterations, keeping the newest ``keep_last``
    COMPLETE ones (per this process's view). Single-process runs remove
    whole directories; multi-process runs drop their own completeness
    marker first, then shard files. Call it from the decode_resumable
    callback right after a successful save — on a SHARED filesystem every
    process must prune at the same point so no process's marker outlives
    the shard files (a stale marker only makes a later load fail loudly
    with a missing-file error, never reassemble wrong data — stamps are
    validated)."""
    import os
    import shutil
    if keep_last < 1:
        raise ValueError("keep_last must be >= 1")
    done_list = _complete_checkpoints(ckpt_dir)
    for done in done_list[:-keep_last]:
        sub = os.path.join(ckpt_dir, f"iter_{done:08d}")
        if jax.process_count() == 1:
            shutil.rmtree(sub, ignore_errors=True)
            continue
        pid = jax.process_index()
        try:
            os.remove(os.path.join(sub, f"COMPLETE.p{pid}"))
        except FileNotFoundError:
            pass
        for name in os.listdir(sub):
            if name.startswith("shard_"):
                try:
                    os.remove(os.path.join(sub, name))
                except FileNotFoundError:
                    pass  # another process's shard or already gone


def load_gl_checkpoint_sharded(ckpt_dir: str, mesh: Mesh,
                               done: int | None = None
                               ) -> tuple[int, jax.Array]:
    """Reassemble a :func:`save_gl_checkpoint_sharded` checkpoint on a mesh
    of the same shape: each process loads only the shard files its own
    devices need and the global carry is built with
    ``jax.make_array_from_single_device_arrays`` — no host ever holds the
    full signal. Returns ``(done, carry)`` for ``decode_resumable(resume=)``.

    ``done=None`` picks the newest checkpoint every process completed: on a
    multi-process mesh the processes agree on min(per-process newest) via a
    host allgather, so a preemption that interrupted some processes' saves
    rolls every process back to the last globally-complete iteration.
    """
    import os
    from jax.sharding import NamedSharding
    if done is None:
        local = _complete_checkpoints(ckpt_dir)
        if not local:
            raise ValueError(f"no complete checkpoint in {ckpt_dir!r}")
        done = local[-1]
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            everyone = np.asarray(multihost_utils.process_allgather(
                np.int64(done)))
            done = int(everyone.min())
            if done not in local:
                raise ValueError(
                    f"globally-agreed checkpoint iter_{done} is not "
                    f"complete on process {jax.process_index()}")
    sub = os.path.join(ckpt_dir, f"iter_{int(done):08d}")
    with open(os.path.join(sub, "META.npz"), "rb") as f:
        z = np.load(f)
        meta_done = int(z["done"])
        shape = tuple(int(d) for d in z["shape"])
        dtype = str(z["dtype"])
    if meta_done != done:
        raise ValueError(f"checkpoint {sub!r} META stamps done={meta_done}")
    sharding = NamedSharding(mesh, P(DATA_AXIS, FRAME_AXIS))
    arrays = []
    for dev, index in sharding.addressable_devices_indices_map(shape).items():
        fname = os.path.join(sub, f"shard_{_index_key(index, shape)}.npz")
        with open(fname, "rb") as f:
            z = np.load(f)
            if int(z["done"]) != done:  # mixed-iteration guard
                raise ValueError(
                    f"shard {fname!r} stamps done={int(z['done'])}, "
                    f"expected {done}")
            data = z["data"].astype(dtype)
        arrays.append(jax.device_put(data, dev))
    carry = jax.make_array_from_single_device_arrays(shape, sharding, arrays)
    return done, carry
