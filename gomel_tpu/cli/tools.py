"""The four CLI tools: tomel, towav, tophase, fromphase.

Behavior parity with the reference Go CLIs (baked-in params, file routing,
error text shape):
- tomel:     /root/reference/cmd/tomel/main.go:11-60
- towav:     /root/reference/cmd/towav/main.go:10-48
- tophase:   /root/reference/cmd/tophase/main.go:11-56
- fromphase: /root/reference/cmd/fromphase/main.go:10-36 (its doc.go documents
  a [sample_rate] argument that main.go never parses — we keep main.go behavior
  and expose the rate as an optional flag instead).

Each tool also grows flags the reference lacks (--output, --seed,
config overrides) without changing the zero-flag default behavior.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from ..core.config import MelConfig, PhaseConfig
from ..pipelines.mel import Mel
from ..pipelines.phase import Phase


def _route_audio_input(filename: str) -> tuple[str, str]:
    """Reference routing: .flac -> flac, .wav -> wav, bare name -> name.wav
    (cmd/tomel/main.go:33-59)."""
    if filename.endswith(".flac"):
        return filename, "flac"
    if filename.endswith(".wav"):
        return filename, "wav"
    return filename + ".wav", "wav"


def _mel_parser(prog: str, png_input: bool) -> argparse.ArgumentParser:
    d = MelConfig.cli_default()   # single source of the reference CLI params
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("filename",
                   help="PNG file" if png_input else
                   "audio file (.wav/.flac; bare name implies .wav)")
    if png_input:
        p.add_argument("sample_rate", nargs="?", type=int, default=44100,
                       help="output sample rate (default 44100)")
        p.add_argument("--seed", type=int, default=0,
                       help="Griffin-Lim PRNG seed")
        p.add_argument("--gl-momentum", type=float, default=0.0,
                       help="fast-GL acceleration (0 = reference behavior). "
                            "Equal-quality pairs "
                            "(ops/griffinlim.py recommended_gl): "
                            "'--gl-momentum 0.99 --griffin-lim-iterations "
                            "24' matches plain 64 iterations; momentum-8 "
                            "matches plain-16; at the default 2 iterations "
                            "momentum 0.99 is par-to-slightly-better")
    p.add_argument("--output", "-o", default=None, help="output path")
    p.add_argument("--num-mels", type=int, default=d.num_mels)
    p.add_argument("--window", type=int, default=d.window)
    p.add_argument("--resolut", type=int, default=d.resolut)
    p.add_argument("--fmax", type=float, default=d.mel_fmax)
    p.add_argument("--griffin-lim-iterations", type=int,
                   default=d.griffin_lim_iterations)
    p.add_argument("--volume-boost", type=float, default=d.volume_boost)
    p.add_argument("--device-quantize", dest="device_quantize",
                   action="store_true", default=True,
                   help="fuse PNG (de)quantization into the device program "
                        "(the default: 8x less host<->device traffic on "
                        "file paths, byte-near output — ops/quantize.py, "
                        "docs/PARITY.md)")
    p.add_argument("--host-quantize", dest="device_quantize",
                   action="store_false",
                   help="byte-exact host-side float64 PNG quantization "
                        "(the reference-oracle personality; slower)")
    return p


def _mel_from_args(a, sample_rate: int = 0) -> Mel:
    return Mel(MelConfig(
        num_mels=a.num_mels, mel_fmin=0.0, mel_fmax=a.fmax, y_reverse=True,
        window=a.window, resolut=a.resolut,
        griffin_lim_iterations=a.griffin_lim_iterations,
        volume_boost=a.volume_boost, sample_rate=sample_rate),
        device_quantize=getattr(a, "device_quantize", False))


def tomel(argv: Optional[Sequence[str]] = None) -> int:
    """audio -> <file>.png mel spectrogram (cmd/tomel/main.go)."""
    a = _mel_parser("tomel", png_input=False).parse_args(argv)
    infile, kind = _route_audio_input(a.filename)
    outfile = a.output or a.filename + ".png"
    m = _mel_from_args(a)
    try:
        if kind == "flac":
            m.to_mel_flac(infile, outfile)
        else:
            m.to_mel_wav(infile, outfile)
    except Exception as e:  # reference prints and exits 1
        print(f"Error generating mel spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def towav(argv: Optional[Sequence[str]] = None) -> int:
    """mel PNG -> <file>.wav (cmd/towav/main.go; argv[2] = sample rate)."""
    a = _mel_parser("towav", png_input=True).parse_args(argv)
    outfile = a.output or a.filename + ".wav"
    m = _mel_from_args(a, sample_rate=a.sample_rate)
    try:
        m.to_wav_png(a.filename, outfile, seed=a.seed,
                     momentum=a.gl_momentum)
    except Exception as e:
        print(f"Error generating wave from spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def _phase_parser(prog: str, png_input: bool) -> argparse.ArgumentParser:
    d = PhaseConfig.cli_default()  # single source of the reference CLI params
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("filename",
                   help="PNG file" if png_input else
                   "audio file (.wav/.flac; bare name implies .wav)")
    p.add_argument("--output", "-o", default=None, help="output path")
    p.add_argument("--num-freqs", type=int, default=d.num_freqs)
    p.add_argument("--window", type=int, default=d.window)
    p.add_argument("--resolut", type=int, default=d.resolut)
    p.add_argument("--volume-boost", type=float, default=d.volume_boost)
    p.add_argument("--ihs", action="store_true")
    p.add_argument("--hdr", action="store_true")
    p.add_argument("--device-quantize", dest="device_quantize",
                   action="store_true", default=True,
                   help="fuse PNG (de)quantization into the device program "
                        "(the default: 4x less host<->device traffic both "
                        "directions, byte-near output — ops/quantize.py, "
                        "docs/PARITY.md)")
    p.add_argument("--host-quantize", dest="device_quantize",
                   action="store_false",
                   help="byte-exact host-side float64 PNG quantization "
                        "(the reference-oracle personality; slower)")
    if png_input:
        p.add_argument("--sample-rate", type=int, default=0,
                       help="override output rate (reference fromphase "
                            "documents but never parses this)")
        p.add_argument("--metadata-layout", choices=("auto", "go", "py"),
                       default="auto",
                       help="metadata layout of the input PNG: 'go' 16-byte, "
                            "'py' 12-byte port layout; 'auto' detects")
    return p


def _phase_from_args(a, sample_rate: int = 0) -> Phase:
    return Phase(PhaseConfig(
        num_freqs=a.num_freqs, window=a.window, resolut=a.resolut,
        y_reverse=True, volume_boost=a.volume_boost, ihs=a.ihs, hdr=a.hdr,
        sample_rate=sample_rate),
        device_quantize=getattr(a, "device_quantize", False))


def tophase(argv: Optional[Sequence[str]] = None) -> int:
    """audio -> <file>.png phase spectrogram (cmd/tophase/main.go)."""
    a = _phase_parser("tophase", png_input=False).parse_args(argv)
    infile, kind = _route_audio_input(a.filename)
    outfile = a.output or a.filename + ".png"
    m = _phase_from_args(a)
    try:
        if kind == "flac":
            m.to_phase_flac(infile, outfile)
        else:
            m.to_phase_wav(infile, outfile)
    except Exception as e:
        print(f"Error generating mel spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def fromphase(argv: Optional[Sequence[str]] = None) -> int:
    """phase PNG -> <file>.wav (cmd/fromphase/main.go)."""
    a = _phase_parser("fromphase", png_input=True).parse_args(argv)
    outfile = a.output or a.filename + ".wav"
    m = _phase_from_args(a, sample_rate=a.sample_rate)
    try:
        m.to_wav_png(a.filename, outfile, layout=a.metadata_layout)
    except Exception as e:
        print(f"Error generating wave from spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Multiplexed entry: ``gomel-tpu <tool> [args...]``."""
    from .batch import (batch_fromphase, batch_tomel, batch_tophase,
                        batch_towav)
    from .export import export_tool, info_tool
    argv = list(sys.argv[1:] if argv is None else argv)
    tools = {"tomel": tomel, "towav": towav,
             "tophase": tophase, "fromphase": fromphase,
             "batch-tomel": batch_tomel, "batch-tophase": batch_tophase,
             "batch-fromphase": batch_fromphase, "batch-towav": batch_towav,
             "export": export_tool, "info": info_tool}
    if not argv or argv[0] not in tools:
        print(f"Usage: gomel-tpu {{{','.join(tools)}}} <args>", file=sys.stderr)
        return 1
    return tools[argv[0]](argv[1:])


def _process_entry(tool):
    """Console-script form of ``tool``: turn on the persistent compilation
    cache for this process (utils/compile_cache.py), then run it. In-process
    callers (library code, tests) call the tool functions directly."""
    def run() -> int:
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        return tool()
    return run


cli = _process_entry(main)
tomel_cli = _process_entry(tomel)
towav_cli = _process_entry(towav)
tophase_cli = _process_entry(tophase)
fromphase_cli = _process_entry(fromphase)


if __name__ == "__main__":
    sys.exit(cli())
