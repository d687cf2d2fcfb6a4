"""The port's MPEG-1 Layer I and Layer II encoders (audio/mpeg.py, the
reference's file but for its x4 resample, which runs on the port's
PyTorch polyphase_resample) against the JAX package's on the CPU, on
tests/test_mpeg.py's inputs: silence, the 1250 Hz and 250 Hz tones, and
the 800 Hz segment of the streaming hook.

The two resamplers sum in different orders, so their 32 kHz PCM differs
by an ulp (held within 1e-6 here); where a subband's content is within an
ulp of a quantizer decision the code flips. The bytes are therefore held
frame by frame: the same frame count, every header, allocation and
scalefactor index equal, and every sample within one quantizer step plus
1e-6 (the resample's tolerance) of the reference's, in amplitude: a code
of a subband whose scalefactor is tiny may move by more than one step
for an ulp of the PCM. Silence encodes to the same bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrtrunk_tpu.audio import mpeg as ref
from sdrtrunk_tpu.audio.segments import AudioSegment as RefSegment
from sdrtrunk_tpu.dsp import fir as ref_fir
from sdrtrunk_tpu_torch import use_device
from sdrtrunk_tpu_torch.audio import mpeg
from sdrtrunk_tpu_torch.audio.segments import AudioSegment

torch.set_num_threads(1)


def _inputs():
    t = np.arange(8000) / 8000.0
    return {
        "silence": np.zeros(9600, np.float32),
        "tone_1250": (0.5 * np.sin(2 * np.pi * 1250.0 * t)
                      ).astype(np.float32),
        "tone_250": (0.5 * np.sin(2 * np.pi * 250.0 * t)).astype(np.float32),
        "segment_800": (0.4 * np.sin(2 * np.pi * 800.0 * t[:4800])
                        ).astype(np.float32),
    }


def _bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8)).astype(np.int64)


def _fields(bits, widths):
    """Consecutive big-endian fields of the given widths from bits."""
    out, pos = [], 0
    for w in widths:
        out.append(int(bits[pos:pos + w].dot(1 << np.arange(w)[::-1])))
        pos += w
    return out


def _layer1(frame: bytes):
    """(header + allocation + scalefactor indices, sample codes, each
    code's quantizer step in amplitude) of a Layer I frame of the
    encoder's fixed scheme (5-bit codes in every subband)."""
    b = _bits(frame)
    sb, nb = mpeg.SUBBANDS, mpeg.QUANT_BITS
    head = _fields(b, [32] + [4] * sb + [6] * sb)
    codes = _fields(b[32 + 10 * sb:], [nb] * (mpeg.GRANULES * sb))
    scf = mpeg._SCALEFACTORS[np.asarray(head[1 + sb:])]        # (32,)
    step = np.tile(2.0 * scf / ((1 << nb) - 1), mpeg.GRANULES)
    return head, np.asarray(codes), step


def _layer2(frame: bytes):
    """The same for a Layer II frame: 8 coded subbands, three
    scalefactors each (one a 12-granule part), 10-bit codes written
    granule, subband, then the three samples of the granule."""
    b = _bits(frame)
    coded, nb = mpeg.L2_CODED_SUBBANDS, mpeg.L2_QUANT_BITS
    widths = ([32] + mpeg._L2_ALLOC_WIDTH + [2] * coded + [6] * (3 * coded))
    head = _fields(b, widths)
    codes = _fields(b[sum(widths):], [nb] * (mpeg.L2_GRANULES * coded))
    scf = mpeg._SCALEFACTORS[np.asarray(head[-3 * coded:])
                             ].reshape(coded, 3)                 # (sb, part)
    gr, sb, _ = np.meshgrid(np.arange(12), np.arange(coded), np.arange(3),
                            indexing="ij")
    step = 2.0 * scf[sb, gr // 4].reshape(-1) / ((1 << nb) - 1)
    return head, np.asarray(codes), step


def _hold_frames(got: bytes, want: bytes, size: int, parse) -> None:
    assert len(got) == len(want) and len(want) % size == 0 and want
    for i in range(0, len(want), size):
        head, codes, step = parse(got[i:i + size])
        head_ref, codes_ref, _ = parse(want[i:i + size])
        assert head == head_ref, f"frame {i // size}"
        assert np.all(np.abs(codes - codes_ref) * step <= step + 1e-6), \
            f"frame {i // size}"


@pytest.mark.parametrize("name", list(_inputs()))
def test_resample_matches_the_reference(name):
    pcm = _inputs()[name]
    taps = np.asarray(ref_fir.resample_taps(4, 1), np.float32)
    want = np.asarray(ref_fir.polyphase_resample(
        jnp.asarray(pcm), jnp.asarray(taps), 4, 1))
    with use_device("cpu"):
        got = mpeg._upsample(pcm, taps, 4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("layer", ["layer1", "layer2"])
@pytest.mark.parametrize("name", list(_inputs()))
def test_encoder_matches_the_reference(name, layer):
    pcm = _inputs()[name]
    cls, size, parse = {
        "layer1": ("MpegLayer1Encoder", mpeg.FRAME_BYTES, _layer1),
        "layer2": ("MpegLayer2Encoder", mpeg.L2_FRAME_BYTES, _layer2)}[layer]
    enc_ref = getattr(ref, cls)()
    want = enc_ref.encode(pcm) + enc_ref.flush()
    with use_device("cpu"):
        enc = getattr(mpeg, cls)()
        got = enc.encode(pcm) + enc.flush()
    _hold_frames(got, want, size, parse)
    if name == "silence":
        assert got == want


def test_streaming_hooks_match_the_reference():
    pcm = _inputs()["segment_800"]
    seg, seg_ref = AudioSegment(sample_rate=8000.0, start_time=0.0), \
        RefSegment(sample_rate=8000.0, start_time=0.0)
    for s in (seg, seg_ref):
        s.add_audio(pcm)
        s.complete_segment()
    for hook, size, parse in ((mpeg.mpeg_layer1_encoder, mpeg.FRAME_BYTES,
                               _layer1),
                              (mpeg.mpeg_layer2_encoder,
                               mpeg.L2_FRAME_BYTES, _layer2)):
        want = getattr(ref, hook.__name__)(seg_ref)
        with use_device("cpu"):
            got = hook(seg)
        _hold_frames(got, want, size, parse)


def test_encoder_follows_the_default_device():
    """Outside a use_device block the resample runs on the card, so on a
    machine without one the encoder raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        mpeg.MpegLayer1Encoder().encode(_inputs()["tone_250"])
