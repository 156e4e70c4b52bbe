#!/usr/bin/env python
"""Example usage of gomel_tpu (the equivalent of the reference's
example_usage.py).

Demonstrates: buffer-level phase round trip, mel encode/decode with
Griffin-Lim, file conversion, the reference-port compat layer, batched
data-parallel pipelines, and frame-sharded long-form processing.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def example_phase_roundtrip():
    print("=== Phase codec (buffer level) ===")
    from gomel_tpu import Phase
    p = Phase(sample_rate=48000)
    print(f"num_freqs={p.config.num_freqs} hop={p.config.window} "
          f"fft={p.config.resolut}")
    sr = 48000
    t = np.arange(sr) / sr
    audio = np.sin(2 * np.pi * 440 * t)
    spec = p.to_phase(audio)                     # [F*num_freqs, 2] flat
    print("spectrogram:", spec.shape)
    rec = p.from_phase(spec)
    n = min(len(audio), len(rec))
    print("corr:", np.corrcoef(audio[4096:n - 4096], rec[4096:n - 4096])[0, 1])


def example_mel_roundtrip():
    print("\n=== Mel codec (device level) ===")
    from gomel_tpu import Mel, MelConfig
    m = Mel(MelConfig.cli_default())             # 192 mels, hop 1280, FFT 4096
    audio = np.random.default_rng(0).standard_normal(48000)
    logmel = m.encode(audio)                     # [F, 192, 2] device array
    print("log-mel:", logmel.shape)
    wav = m.decode(logmel, seed=0)               # Griffin-Lim, explicit PRNG
    print("reconstructed:", wav.shape)
    # opt-in fast-GL (FGLA momentum): ~2-4x fewer iterations for equal
    # convergence at about the same per-iteration cost (ops/griffinlim.py)
    wav_fast = m.decode(logmel, seed=0, momentum=0.99)
    print("fast-GL reconstructed:", wav_fast.shape)


def example_files(tmpdir=None):
    print("\n=== File conversion ===")
    import tempfile
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="gomel_example_")
    from gomel_tpu import Phase
    from gomel_tpu.io.audio import save_wav
    sr = 48000
    t = np.arange(2 * sr) / sr
    save_wav(f"{tmpdir}/in.wav", 0.5 * np.sin(2 * np.pi * 440 * t), sr)
    Phase(sample_rate=sr).to_phase_wav(f"{tmpdir}/in.wav", f"{tmpdir}/p.png")
    rate = Phase(sample_rate=sr).to_wav_png(f"{tmpdir}/p.png",
                                            f"{tmpdir}/out.wav")
    print(f"wrote {tmpdir}/out.wav at {rate} Hz")
    # the fused fast path (the CLI default): raw int16 upload, on-device
    # (de)quantization, int16 PCM readback — byte-near output, a quarter of
    # the host<->device bytes
    fast = Phase(sample_rate=sr, device_quantize=True)
    fast.to_phase_wav(f"{tmpdir}/in.wav", f"{tmpdir}/p_fast.png")
    fast.to_wav_png(f"{tmpdir}/p_fast.png", f"{tmpdir}/out_fast.wav")
    print("device-quantize fast path: wrote out_fast.wav")


def example_compat():
    print("\n=== Drop-in reference-port compat ===")
    from gomel_tpu.compat import phase  # same surface as `import phase`
    p = phase.Phase(sample_rate=44100)
    audio = phase.pad(np.random.default_rng(1).standard_normal(30000), 1280)
    spec = p.to_phase(audio)
    print("compat spectrogram:", spec.shape)


def example_batched():
    print("\n=== Batched data-parallel pipeline ===")
    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.parallel import BatchedMel, make_buckets
    bm = BatchedMel(MelConfig(window=256, resolut=2048, num_mels=80))
    utts = [np.random.default_rng(i).standard_normal(n).astype(np.float32)
            for i, n in enumerate([8000, 8500, 30000])]
    for bucket, logmel in bm.encode_buckets(utts):
        print(f"bucket len={bucket.padded_len}: logmel {logmel.shape}")


def example_longform():
    print("\n=== Frame-sharded long-form (multi-chip) ===")
    import jax
    if len(jax.devices()) < 2:
        print("(single device; mesh of 1 — same code path)")
    from gomel_tpu.core.config import PhaseConfig
    from gomel_tpu.parallel.mesh import make_mesh
    from gomel_tpu.pipelines.longform import LongFormPhase
    n = len(jax.devices())
    mesh = make_mesh(data=1, frame=n)
    lf = LongFormPhase(PhaseConfig(num_freqs=96, window=64, resolut=256), mesh)
    x = np.random.default_rng(2).standard_normal(20000).astype(np.float32)
    spec = lf.encode(x)
    wav = lf.decode(spec)
    print(f"frame-sharded over {n} devices: spec {spec.shape} wav {wav.shape}")

    # resumable Griffin-Lim decode: run in preemption-safe segments, persist
    # a checkpoint, resume after a "crash" — bit-identical to one-call decode
    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.pipelines.longform import (LongFormMel,
                                              load_gl_checkpoint,
                                              save_gl_checkpoint)
    mcfg = MelConfig(num_mels=24, window=64, resolut=256,
                     griffin_lim_iterations=8)
    lfm = LongFormMel(mcfg, mesh)
    logmel = lfm.encode(x)
    ckpt = "/tmp/gomel_tpu_example/gl_ckpt.npz"
    import os
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    lfm.decode_resumable(
        logmel, seed=0, segment_iters=4,
        callback=lambda done, carry: save_gl_checkpoint(ckpt, done, carry)
        if done == 4 else None)
    resumed = lfm.decode_resumable(logmel, seed=0, segment_iters=4,
                                   resume=load_gl_checkpoint(ckpt))
    one_call = lfm.decode(logmel, seed=0)
    same = bool(np.array_equal(np.asarray(resumed), np.asarray(one_call)))
    print(f"resumable GL decode: resumed-from-checkpoint == one-call: {same}")


def example_serving(tmpdir=None):
    print("\n=== AOT serving artifact (jax.export) ===")
    import tempfile
    tmpdir = tmpdir or tempfile.mkdtemp(prefix="gomel_example_")
    import jax.numpy as jnp
    from gomel_tpu import MelConfig, serving
    cfg = MelConfig.cli_default()
    # build once (weights baked in, symbolic batch), ship the bytes
    exp = serving.export_mel_encoder(cfg, seconds=2.0, sample_rate=48000,
                                     batch=None)
    path = f"{tmpdir}/mel_enc.jaxexp"
    serving.save_exported(exp, path, meta=serving.artifact_meta(
        exp, cfg, kind="mel-enc", seconds=2.0, sample_rate=48000))
    art = serving.load_exported(path)          # serving host: no framework JIT
    n = exp.in_avals[0].shape[1]
    batch = np.random.default_rng(3).standard_normal((4, n)).astype(np.float32)
    logmel = art.call(jnp.asarray(batch))
    meta = serving.read_artifact_meta(path)    # self-describing: no filename
    print(f"artifact {os.path.getsize(path)} bytes "
          f"(kind={meta['kind']}, mels={meta['config']['num_mels']}); "
          f"batch {batch.shape} -> log-mel {logmel.shape}")


if __name__ == "__main__":
    example_phase_roundtrip()
    example_mel_roundtrip()
    example_files()
    example_compat()
    example_batched()
    example_longform()
    example_serving()
