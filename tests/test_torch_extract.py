"""The port's channel extraction and band occupancy (dsp/extract.py,
dsp/spectrum.py) against the JAX package on the CPU.

* plan_channels: the same bin pairs, residual offsets and rate for one-
  and two-bin channels at the same offsets, and the same refusals (wider
  than two bins, outside the coverage).
* extract_channels on the same channelizer output (the reference's, on a
  seeded random capture): streams within 1e-5 of the reference's (the
  mixer's float32 angle and cos/sin), over two chunks with the mixer
  phase and rotator index carried, and the carried phase within 1e-5.
* spectrogram on a two-tone capture: the same frame count, each bin's
  linear power within 2e-6 of the peak's (the two float32 FFTs' rounding;
  a bin 90 dB down may differ by a tenth of a dB); channel_power_map: the
  same centers and power within 1e-3 dB (the CLI's info prints it to 0.1
  dB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.dsp import extract as ref_extract
from sdrtrunk_tpu.dsp import spectrum as ref_spectrum
from sdrtrunk_tpu.dsp.channelizer import Channelizer as RefChannelizer
from sdrtrunk_tpu_torch.dsp import extract, spectrum
from sdrtrunk_tpu_torch.dsp.channelizer import Channelizer

torch.set_num_threads(1)

FS = 64 * 12500.0
# one-bin channels (on and off a bin's center, negative, wrapping) and
# two-bin ones (bandwidth 25 kHz)
OFFSETS = [0.0, 37500.0, -100_000.0 + 1200.0, 393_750.0, 18750.0,
           -56250.0]
BANDWIDTHS = [12500.0, 12500.0, 12500.0, 12500.0, 25000.0, 25000.0]


def _pair():
    return (RefChannelizer.design(FS, 12500.0),
            Channelizer.design(FS, 12500.0, device="cpu"))


def test_plan_matches_the_reference():
    ref_ch, ch = _pair()
    want = ref_extract.plan_channels(ref_ch, OFFSETS, BANDWIDTHS)
    got = extract.plan_channels(ch, OFFSETS, BANDWIDTHS)
    np.testing.assert_array_equal(got.bins, want.bins)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.wide, want.wide)
    assert got.rate == want.rate and got.count == want.count == 6
    np.testing.assert_array_equal(
        extract.plan_channels(ch, OFFSETS[:4]).bins,
        ref_extract.plan_channels(ref_ch, OFFSETS[:4]).bins)


@pytest.mark.parametrize("offsets,bandwidths", [
    ([0.0], [40000.0]), ([FS], None)], ids=["three_bins", "outside"])
def test_plan_refuses_as_the_reference(offsets, bandwidths):
    ref_ch, ch = _pair()
    with pytest.raises(ValueError) as want:
        ref_extract.plan_channels(ref_ch, offsets, bandwidths)
    with pytest.raises(ValueError) as got:
        extract.plan_channels(ch, offsets, bandwidths)
    assert str(got.value) == str(want.value)


def test_extract_matches_the_reference_over_two_chunks():
    ref_ch, ch = _pair()
    rng = np.random.default_rng(3)
    n = 64 * 400
    x = ((rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
         * 0.3).astype(np.complex64)
    plan_ref = ref_extract.plan_channels(ref_ch, OFFSETS, BANDWIDTHS)
    plan = extract.plan_channels(ch, OFFSETS, BANDWIDTHS)
    state = None
    phase_ref = phase = None
    for j in range(2):
        y, state = ref_ch(jnp.asarray(x[j * n:(j + 1) * n]), state)
        want, phase_ref = ref_extract.extract_channels(
            y, plan_ref, phase_ref, gain=0.7)
        got, phase = extract.extract_channels(
            torch.as_tensor(np.array(y)), plan, phase, gain=0.7)
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(phase[0].numpy(),
                                   np.asarray(phase_ref[0]), rtol=0,
                                   atol=1e-5)
        assert phase[1] == int(phase_ref[1])


def test_spectrum_and_power_map_match_the_reference():
    t = np.arange(1 << 14)
    x = (0.5 * np.exp(2j * np.pi * 37500.0 * t / FS)
         + 0.05 * np.exp(-2j * np.pi * 150_000.0 * t / FS)
         + 1e-3 * np.random.default_rng(4).standard_normal(len(t))
         ).astype(np.complex64)
    want = np.asarray(ref_spectrum.spectrogram(jnp.asarray(x)))
    got = spectrum.spectrogram(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (31, 1024)
    peak = 10.0 ** (want.max() / 10.0)
    np.testing.assert_allclose(10.0 ** (got / 10.0), 10.0 ** (want / 10.0),
                               rtol=0, atol=2e-6 * peak)
    c_ref, p_ref = ref_spectrum.channel_power_map(jnp.asarray(x), FS)
    c, p = spectrum.channel_power_map(torch.as_tensor(x), FS)
    np.testing.assert_array_equal(c, c_ref)
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-3)
    short = spectrum.power_spectrum(torch.as_tensor(x[:100]))
    np.testing.assert_array_equal(
        short.numpy(), np.asarray(ref_spectrum.power_spectrum(
            jnp.asarray(x[:100]))))
