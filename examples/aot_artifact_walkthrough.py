#!/usr/bin/env python
"""AOT serving walkthrough: build artifacts on a CPU host, ship, call.

The production split (serving.py): artifacts are BUILT once, on any host
(a CPU build host needs no GPU: the exports are lowered for
platforms=("cuda", "cpu")). The serving host then just loads bytes and
calls — no framework tracing, no weight files (the filterbank is baked into
the HLO as a constant; re-export to change it).

This script demonstrates both artifact families:

  1. single-chip batched mel encoder/decoder (export_mel_*): symbolic batch
     dim, called with plain ``.call``
  2. frame-sharded LONGFORM encoder over a mesh (export_longform_*): built
     for a mesh over every visible device, invoked with ``call_longform``
     which shards the host inputs the way the artifact expects

Runnable anywhere:  python examples/aot_artifact_walkthrough.py
(with GOMEL_FORCE_CPU=1 it uses 8 virtual CPU devices; on a GPU host, the
visible cards).
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
# GOMEL_FORCE_CPU (set by tests/test_examples.py) runs on the 8 virtual CPU
# devices; otherwise the example runs on the default backend, e.g. the GPU
if os.environ.get("GOMEL_FORCE_CPU"):
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np


def build(tmpdir: str) -> dict:
    """The BUILD host (CPU): export, stamp self-describing metadata, save."""
    from gomel_tpu import MelConfig, serving
    cfg = MelConfig.cli_default()

    paths = {}
    # 1a. batched encoder, symbolic batch: one artifact serves any B
    enc = serving.export_mel_encoder(cfg, seconds=2.0, sample_rate=48000,
                                     batch=None)
    paths["enc"] = os.path.join(tmpdir, "mel_enc.gmel")
    serving.save_exported(enc, paths["enc"], meta=serving.artifact_meta(
        enc, cfg, kind="mel-encoder", seconds=2.0, sample_rate=48000))

    # 1b. batched Griffin-Lim decoder at the frontier recommendation:
    # momentum-24 == plain GL-64 quality in 2.7x fewer iterations
    from gomel_tpu.ops.griffinlim import recommended_gl
    mom, iters = recommended_gl(64)
    import dataclasses
    dcfg = dataclasses.replace(cfg, griffin_lim_iterations=iters)
    n_frames = enc.out_avals[0].shape[1]
    dec = serving.export_mel_decoder(dcfg, n_frames=n_frames, batch=None,
                                     momentum=mom)
    paths["dec"] = os.path.join(tmpdir, "mel_dec.gmel")
    serving.save_exported(dec, paths["dec"], meta=serving.artifact_meta(
        dec, dcfg, kind="mel-decoder", momentum=mom))

    # 2. frame-sharded longform encoder over a (1 x n_devices) mesh
    from gomel_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(data=1, frame=len(jax.devices()))
    lf = serving.export_longform_mel_encoder(cfg, mesh, n_frames=64, batch=1)
    paths["lf"] = os.path.join(tmpdir, "longform_enc.gmel")
    serving.save_exported(lf, paths["lf"], meta=serving.artifact_meta(
        lf, cfg, kind="longform-mel-encoder", n_frames=64))

    for k, p in paths.items():
        meta = serving.read_artifact_meta(p)  # header-only read
        print(f"built {k}: {os.path.getsize(p):,} bytes, "
              f"kind={meta['kind']}, platforms={meta['platforms']}")
    return paths


def serve(paths: dict) -> None:
    """The SERVING host: load bytes, call. No tracing, no config objects."""
    from gomel_tpu import serving
    rng = np.random.default_rng(0)

    enc = serving.load_exported(paths["enc"])
    n = enc.in_avals[0].shape[1]
    batch = rng.standard_normal((4, n)).astype(np.float32)
    logmel = enc.call(jnp.asarray(batch))
    print(f"encoder: {batch.shape} -> {logmel.shape}")

    dec = serving.load_exported(paths["dec"])
    keys = np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(4)])
    wav = dec.call(logmel, jnp.asarray(keys, jnp.uint32))
    print(f"decoder (momentum-GL): {logmel.shape} -> {wav.shape}")

    # longform: call_longform shards host inputs over the mesh for you
    from gomel_tpu.parallel.mesh import make_mesh
    from gomel_tpu.serving import call_longform
    mesh = make_mesh(data=1, frame=len(jax.devices()))
    lf = serving.load_exported(paths["lf"])
    sig_len = lf.in_avals[0].shape[1]
    long_audio = rng.standard_normal((1, sig_len)).astype(np.float32)
    lf_logmel = call_longform(lf, mesh, long_audio)
    print(f"longform encoder over {len(jax.devices())} devices: "
          f"{long_audio.shape} -> {lf_logmel.shape}")
    assert np.isfinite(np.asarray(lf_logmel)).all()
    print("OK")


def main():
    with tempfile.TemporaryDirectory(prefix="gomel-aot-") as d:
        serve(build(d))


if __name__ == "__main__":
    main()
