"""Property-based parity fuzzing against the reference Python port.

Random audio, lengths, and configurations through BOTH implementations;
outputs must agree to float32-class tolerance. This is the strongest
correctness evidence for the phase codec (the reference port is the
executable spec, /root/reference/phase.py).
"""
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from conftest import load_reference_phase
from gomel_tpu.compat import phase as compat

ref = load_reference_phase()
pytestmark = pytest.mark.skipif(ref is None,
                                reason="reference port unavailable")

_settings = settings(max_examples=12, deadline=None,
                     suppress_health_check=[HealthCheck.too_slow])


@_settings
@given(seed=st.integers(0, 2 ** 32 - 1),
       n=st.integers(100, 40000),
       sr=st.sampled_from([8000, 16000, 24000, 32000, 48000,
                           11025, 22050, 44100]))
def test_to_phase_parity_fuzz(seed, n, sr):
    rng = np.random.default_rng(seed)
    audio = compat.pad(rng.uniform(-1, 1, n), 1280)
    ours = compat.Phase(sample_rate=sr).to_phase(audio)
    theirs = ref.Phase(sample_rate=sr).to_phase(audio)
    assert ours.shape == theirs.shape
    scale = max(np.abs(theirs).max(), 1.0)
    np.testing.assert_allclose(ours, theirs, atol=3e-6 * scale)


@_settings
@given(seed=st.integers(0, 2 ** 32 - 1), frames=st.integers(1, 6))
def test_from_phase_parity_fuzz(seed, frames):
    rng = np.random.default_rng(seed)
    nf = 768
    spec = rng.standard_normal((frames * nf, 2)) * 10.0
    ours = compat.Phase(sample_rate=48000).from_phase(spec)
    theirs = ref.Phase(sample_rate=48000).from_phase(spec)
    assert ours.shape == theirs.shape
    # the edge-fade formula computes (sig/wsum)*(wsum/threshold) — the
    # intermediate can be ~1e4x the result, so float32 loses ~3 digits
    # relative to the float64 oracle there
    scale = max(np.abs(theirs).max(), 1e-3)
    np.testing.assert_allclose(ours, theirs, atol=5e-4 * scale)


@_settings
@given(seed=st.integers(0, 2 ** 32 - 1),
       zp=st.integers(1, 4), zs=st.integers(1, 5),
       n=st.integers(1, 3000))
def test_zero_stuff_parity_fuzz(seed, zp, zs, n):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal(n)
    np.testing.assert_allclose(compat.zero_stuff_upsample(buf, zp, zs),
                               ref.zero_stuff_upsample(buf, zp, zs))


@_settings
@given(seed=st.integers(0, 2 ** 32 - 1), frames=st.integers(1, 5),
       y_reverse=st.booleans())
def test_save_load_image_parity_fuzz(seed, frames, y_reverse,
                                     tmp_path_factory):
    rng = np.random.default_rng(seed)
    nf = 768
    spec = rng.standard_normal((frames * nf, 2)) * rng.uniform(0.1, 50)
    d = tmp_path_factory.mktemp("ofz")
    f_ours = str(d / "ours.png")
    f_ref = str(d / "ref.png")
    compat.save_image(f_ours, spec, nf, 3.25, 48000, y_reverse, False, 0)
    ref.save_image(f_ref, spec, nf, 3.25, 48000, y_reverse, False, 0)
    with open(f_ours, "rb") as a, open(f_ref, "rb") as b:
        ours_png, ref_png = a.read(), b.read()
    # decoded pixels must be identical even if compressors differ
    got_o = compat.load_image(f_ours, y_reverse, False, 0)
    got_r = ref.load_image(f_ref, y_reverse, False, 0)
    np.testing.assert_array_equal(got_o[0], got_r[0])
    assert got_o[1:] == pytest.approx(got_r[1:])
    # and cross-reads agree
    cross = ref.load_image(f_ours, y_reverse, False, 0)
    np.testing.assert_array_equal(cross[0], got_r[0])


@_settings
@given(seed=st.integers(0, 2 ** 32 - 1), frames=st.integers(1, 4),
       y_reverse=st.booleans())
def test_save_load_image_hdr_parity_fuzz(seed, frames, y_reverse,
                                         tmp_path_factory):
    """HDR (16-bit) leg, de-circularized: the reference oracle writes via the
    pypng shim (which is backed by our container writer), so the container
    under test is additionally decoded with OpenCV — an independent 16-bit
    PNG decoder (PIL downconverts 16-bit RGB, so cv2 is the independent one
    here) — and must byte-match our reader's view of the same file
   ."""
    cv2 = pytest.importorskip("cv2")
    from gomel_tpu.io.pngcodec import read_png

    rng = np.random.default_rng(seed)
    nf = 1536  # HDR doubles num_freqs (reference phase.py:52-55)
    spec = rng.standard_normal((frames * nf, 2)) * rng.uniform(0.1, 50)
    d = tmp_path_factory.mktemp("ofzh")
    f_ours = str(d / "ours.png")
    f_ref = str(d / "ref.png")
    compat.save_image(f_ours, spec, nf, 3.25, 48000, y_reverse, True, 0)
    ref.save_image(f_ref, spec, nf, 3.25, 48000, y_reverse, True, 0)
    for f in (f_ours, f_ref):
        independent = cv2.imread(f, cv2.IMREAD_UNCHANGED)
        assert independent is not None and independent.dtype == np.uint16
        own = read_png(f)
        np.testing.assert_array_equal(own, independent[:, :, [2, 1, 0]])
    got_o = compat.load_image(f_ours, y_reverse, True, 0)
    got_r = ref.load_image(f_ref, y_reverse, True, 0)
    np.testing.assert_array_equal(got_o[0], got_r[0])
    assert got_o[1:] == pytest.approx(got_r[1:])
    cross = ref.load_image(f_ours, y_reverse, True, 0)
    np.testing.assert_array_equal(cross[0], got_r[0])
