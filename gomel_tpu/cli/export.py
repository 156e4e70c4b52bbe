"""``gomel-tpu export`` — build AOT serving artifacts from the command line.

Ops-facing front end for gomel_tpu/serving.py (no reference counterpart —
the reference CLIs re-JIT per process; this bakes the codec into a portable
StableHLO artifact once at build time):

    gomel-tpu export mel-enc out.jaxexp --seconds 30
    gomel-tpu export mel-dec out.jaxexp --n-frames 1122 --momentum 0.99
    gomel-tpu export phase-enc out.jaxexp --seconds 30 --sample-rate 48000
    gomel-tpu export phase-dec out.jaxexp --n-frames 1122

Mel tools default to the reference CLI preset (192 mels — what tomel/towav
write); ``--preset lib`` selects the bare NewMel defaults (160). Phase tools
take ``--sample-rate`` (port constructor semantics, num_freqs derived) or
``--preset cli`` for the tophase/fromphase parameters. ``--batch 0``
(default) exports a symbolic batch dimension — one artifact serves every
batch size; a positive value pins it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("output", help="artifact path to write (.jaxexp)")
    p.add_argument("--batch", type=int, default=0,
                   help="pinned batch size; 0 = symbolic (any batch)")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated lowering platforms")


def _mel_cfg(a):
    from ..core.config import MelConfig
    return MelConfig.cli_default() if a.preset == "cli" else MelConfig()


def _phase_cfg(a):
    from ..core.config import PhaseConfig
    if a.preset == "cli":
        return PhaseConfig.cli_default()
    return PhaseConfig.for_sample_rate(a.sample_rate)


def info_tool(argv: Optional[Sequence[str]] = None) -> int:
    """``gomel-tpu info <artifact>`` — print an artifact's JSON
    self-description header (no StableHLO deserialization, no device)."""
    import json
    p = argparse.ArgumentParser(prog="gomel-tpu info")
    p.add_argument("artifact", help=".jaxexp path")
    a = p.parse_args(argv)
    from .. import serving
    print(json.dumps(serving.read_artifact_meta(a.artifact), indent=2))
    return 0


def export_tool(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="gomel-tpu export")
    sub = parser.add_subparsers(dest="kind", required=True)

    me = sub.add_parser("mel-enc", help="[B,T] audio -> [B,F,M,2] log-mel")
    _common(me)
    me.add_argument("--seconds", type=float, required=True)
    me.add_argument("--sample-rate", type=int, default=48000)
    me.add_argument("--preset", choices=("cli", "lib"), default="cli")

    md = sub.add_parser("mel-dec",
                        help="([B,F,M,2] log-mel, [B,2] keys) -> [B,L] audio")
    _common(md)
    md.add_argument("--n-frames", type=int, required=True)
    md.add_argument("--momentum", type=float, default=0.0,
                    help="fast-GL momentum baked into the artifact")
    md.add_argument("--preset", choices=("cli", "lib"), default="cli")

    pe = sub.add_parser("phase-enc", help="[B,T] audio -> [B,F,NF,2] phase")
    _common(pe)
    pe.add_argument("--seconds", type=float, required=True)
    pe.add_argument("--sample-rate", type=int, default=48000)
    pe.add_argument("--preset", choices=("cli", "sr"), default="sr")

    pd = sub.add_parser("phase-dec", help="[B,F,NF,2] phase -> [B,L] audio")
    _common(pd)
    pd.add_argument("--n-frames", type=int, required=True)
    pd.add_argument("--sample-rate", type=int, default=48000)
    pd.add_argument("--preset", choices=("cli", "sr"), default="sr")

    # per-kind preset choices mirror the non-quantized parsers: _mel_cfg
    # understands ("cli", "lib"), _phase_cfg ("cli", "sr") — offering more
    # would be silently misread
    meq = sub.add_parser("mel-enc-q",
                         help="[B,T] audio -> (uint8 planes, extrema): mel "
                              "encode with the PNG quantizer fused in")
    _common(meq)
    meq.add_argument("--seconds", type=float, required=True)
    meq.add_argument("--sample-rate", type=int, default=48000)
    meq.add_argument("--preset", choices=("cli", "lib"), default="cli")

    peq = sub.add_parser("phase-enc-q",
                         help="[B,T] audio -> (uint8/16 planes, extrema): "
                              "phase encode with the PNG quantizer fused in")
    _common(peq)
    peq.add_argument("--seconds", type=float, required=True)
    peq.add_argument("--sample-rate", type=int, default=48000)
    peq.add_argument("--preset", choices=("cli", "sr"), default="sr")

    mdq = sub.add_parser("mel-dec-q",
                         help="(uint8 planes, extrema, keys) -> int16 PCM: "
                              "fused dequantize + Griffin-Lim + PCM-16")
    _common(mdq)
    mdq.add_argument("--n-frames", type=int, required=True)
    mdq.add_argument("--momentum", type=float, default=0.0,
                     help="fast-GL acceleration baked into the artifact "
                          "(ops/griffinlim.recommended_gl)")
    mdq.add_argument("--preset", choices=("cli", "lib"), default="cli")

    pdq = sub.add_parser("phase-dec-q",
                         help="(planes, extrema) -> int16 PCM: fused "
                              "dequantize + iSTFT + PCM-16")
    _common(pdq)
    pdq.add_argument("--n-frames", type=int, required=True)
    pdq.add_argument("--sample-rate", type=int, default=48000)
    pdq.add_argument("--preset", choices=("cli", "sr"), default="sr")

    pr = sub.add_parser("phase-rt",
                        help="[B,T] audio -> [B,L] audio: ONE fused "
                             "encode->decode program")
    _common(pr)
    pr.add_argument("--seconds", type=float, required=True)
    pr.add_argument("--sample-rate", type=int, default=48000)
    pr.add_argument("--preset", choices=("cli", "sr"), default="sr")

    a = parser.parse_args(argv)
    from .. import serving
    batch = a.batch if a.batch > 0 else None
    platforms = tuple(s.strip() for s in a.platforms.split(",") if s.strip())

    extra = {}
    if a.kind == "mel-enc":
        cfg = _mel_cfg(a)
        exp = serving.export_mel_encoder(
            cfg, seconds=a.seconds, sample_rate=a.sample_rate,
            batch=batch, platforms=platforms)
        extra = {"seconds": a.seconds, "sample_rate": a.sample_rate}
    elif a.kind == "mel-dec":
        cfg = _mel_cfg(a)
        exp = serving.export_mel_decoder(
            cfg, n_frames=a.n_frames, batch=batch,
            momentum=a.momentum, platforms=platforms)
        extra = {"n_frames": a.n_frames, "momentum": a.momentum}
    elif a.kind == "phase-enc":
        cfg = _phase_cfg(a)
        exp = serving.export_phase_encoder(
            cfg, seconds=a.seconds, sample_rate=a.sample_rate,
            batch=batch, platforms=platforms)
        extra = {"seconds": a.seconds, "sample_rate": a.sample_rate}
    elif a.kind == "phase-rt":
        cfg = _phase_cfg(a)
        exp = serving.export_phase_roundtrip(
            cfg, seconds=a.seconds, sample_rate=a.sample_rate,
            batch=batch, platforms=platforms)
        extra = {"seconds": a.seconds, "sample_rate": a.sample_rate}
    elif a.kind == "mel-enc-q":
        cfg = _mel_cfg(a)
        exp = serving.export_mel_encoder_quantized(
            cfg, seconds=a.seconds, sample_rate=a.sample_rate,
            batch=batch, platforms=platforms)
        extra = {"seconds": a.seconds, "sample_rate": a.sample_rate}
    elif a.kind == "phase-enc-q":
        cfg = _phase_cfg(a)
        exp = serving.export_phase_encoder_quantized(
            cfg, seconds=a.seconds, sample_rate=a.sample_rate,
            batch=batch, platforms=platforms)
        extra = {"seconds": a.seconds, "sample_rate": a.sample_rate}
    elif a.kind == "mel-dec-q":
        cfg = _mel_cfg(a)
        exp = serving.export_mel_decoder_quantized(
            cfg, n_frames=a.n_frames, batch=batch, momentum=a.momentum,
            platforms=platforms)
        extra = {"n_frames": a.n_frames, "momentum": a.momentum}
    elif a.kind == "phase-dec-q":
        cfg = _phase_cfg(a)
        exp = serving.export_phase_decoder_quantized(
            cfg, n_frames=a.n_frames, batch=batch, platforms=platforms)
        extra = {"n_frames": a.n_frames}
    else:
        cfg = _phase_cfg(a)
        exp = serving.export_phase_decoder(
            cfg, n_frames=a.n_frames, batch=batch,
            platforms=platforms)
        extra = {"n_frames": a.n_frames}

    serving.save_exported(
        exp, a.output,
        meta=serving.artifact_meta(exp, cfg, kind=a.kind, **extra))
    shapes = ", ".join(str(tuple(av.shape)) for av in exp.in_avals)
    print(f"wrote {a.output}: in {shapes}, platforms {exp.platforms}",
          file=sys.stderr)
    return 0
