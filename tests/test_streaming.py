"""Streaming pipeline parity: chunked results equal the batch pipelines."""
import numpy as np
import pytest

from gomel_tpu.core.config import PhaseConfig
from gomel_tpu.core.framing import pad_length
from gomel_tpu.pipelines.phase import Phase
from gomel_tpu.pipelines.streaming import StreamingPhase

CFG = dict(num_freqs=96, window=64, resolut=256)


def _sig(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float64)


@pytest.mark.parametrize("n", [5000, 12345, 64 * 15 - 1])
def test_streaming_encode_matches_batch(n):
    audio = _sig(n)
    batch = Phase(PhaseConfig(**CFG))
    want = np.asarray(batch.encode(audio))
    s = StreamingPhase(PhaseConfig(**CFG), chunk_frames=16)
    got = s.encode(audio)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_streaming_encode_from_pieces():
    audio = _sig(20000, seed=1)
    s = StreamingPhase(PhaseConfig(**CFG), chunk_frames=32)
    pieces = np.array_split(audio, 7)
    got = np.concatenate(list(s.encode_iter(pieces)), axis=0)
    want = s.encode(audio)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("frames", [40, 97, 16])
def test_streaming_decode_matches_batch(frames):
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((frames, 96, 2))
    batch = Phase(PhaseConfig(**CFG))
    want = np.asarray(batch.decode(spec))
    s = StreamingPhase(PhaseConfig(**CFG), chunk_frames=16)
    got = s.decode(spec)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_streaming_roundtrip_correlation():
    sr = 48000
    cfg = PhaseConfig(num_freqs=768, window=1280, resolut=4096)
    t = np.arange(pad_length(2 * sr, 1280)) / sr
    audio = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 2000 * t)
    s = StreamingPhase(cfg, chunk_frames=24)
    rec = s.decode(s.encode(audio))
    n = min(len(rec), len(audio))
    corr = np.corrcoef(audio[4096:n - 4096], rec[4096:n - 4096])[0, 1]
    assert corr > 0.999


def test_streaming_memory_is_bounded():
    # the streamer never holds more than ~chunk worth of samples
    s = StreamingPhase(PhaseConfig(**CFG), chunk_frames=8)
    total = 0
    for out in s.encode_iter(_sig(300) for _ in range(200)):
        total += out.shape[0]
    padded = pad_length(300 * 200, 64)
    expected_frames = (padded - 256) // 64 + 1
    assert total == expected_frames


def test_streaming_mel_matches_batch():
    from gomel_tpu.core.config import MelConfig
    from gomel_tpu.pipelines.mel import Mel
    from gomel_tpu.pipelines.streaming import StreamingMel
    cfg = MelConfig(num_mels=24, window=64, resolut=256)
    audio = _sig(13000, seed=4)
    want = np.asarray(Mel(cfg).encode(audio))
    s = StreamingMel(cfg, chunk_frames=16)
    got = np.concatenate(list(s.encode_iter(np.array_split(audio, 5))), axis=0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_streaming_tail_larger_than_chunk_regression():
    # reference padding can push the final tail past one chunk when
    # resolut % window != 0 (flagship 4096/1280), and short streams with
    # tiny chunks hit the same path
    s = StreamingPhase(PhaseConfig(num_freqs=768, window=1280, resolut=4096),
                       chunk_frames=512)
    out = s.encode(np.random.default_rng(0).standard_normal(658175))
    padded = pad_length(658175, 1280)
    assert out.shape[0] == (padded - 4096) // 1280 + 1

    s2 = StreamingPhase(PhaseConfig(**CFG), chunk_frames=4)
    out2 = s2.encode(np.random.default_rng(1).standard_normal(100))
    batch = Phase(PhaseConfig(**CFG))
    want = np.asarray(batch.encode(np.random.default_rng(1).standard_normal(100)))
    assert out2.shape == want.shape


@pytest.mark.parametrize("frames", [1, 2, 3, 4, 5])
def test_short_stream_threshold_boundary(frames):
    """Single-block streams shorter than K = ceil(resolut/hop) frames have a
    whole-signal window-sum max BELOW the periodic-interior max (numerically:
    1.0 / 1.2096 / 1.2097 for F=1/2/3 vs interior 1.2098 at the test
    geometry), so the round-1 interior threshold diverged from the batch
    decoder there. The streaming decoder now uses
    the exact per-length threshold for single-block streams — equality must
    hold for EVERY stream length, including F < K."""
    rng = np.random.default_rng(10 + frames)
    spec = rng.standard_normal((frames, 96, 2))
    want = np.asarray(Phase(PhaseConfig(**CFG)).decode(spec))
    got = StreamingPhase(PhaseConfig(**CFG), chunk_frames=16).decode(spec)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_chunk_frames_below_k_rejected():
    """chunk_frames < K would let a multi-chunk stream normalize its first
    block with an interior threshold the short total stream never reaches;
    the constructor forbids the geometry instead."""
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingPhase(PhaseConfig(**CFG), chunk_frames=3)


def test_decode_iter_applies_volume_boost():
    cfg = PhaseConfig(volume_boost=2.0, **CFG)
    spec = np.random.default_rng(3).standard_normal((40, 96, 2))
    s = StreamingPhase(cfg, chunk_frames=16)
    via_iter = np.concatenate(list(s.decode_iter([spec])))
    want = np.asarray(Phase(cfg).decode(spec))
    np.testing.assert_allclose(via_iter, want, atol=5e-4, rtol=2e-3)
