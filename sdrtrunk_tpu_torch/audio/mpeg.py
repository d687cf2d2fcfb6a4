"""MPEG-1 Audio Layer I encoder (mono) for stream egress.

Role of the reference's MP3 conversion stage
(audio/convert/MP3AudioConverter.java, java-lame): turn 8 kHz call audio
into an MPEG audio elementary stream that Icecast/Shoutcast/Broadcastify
accept as audio/mpeg. The reference links LAME (Layer III); shipping a
faithful Layer III encoder (MDCT + psychoacoustics + Huffman) is a
vendor-plugin-sized job, so — like the reference treats its voice codec —
the streaming encoder is pluggable, and the IN-REPO encoder implements
MPEG-1 Audio **Layer I** (ISO/IEC 11172-3), the simplest layer of the
same family: every MPEG audio decoder (and both streaming servers)
handles it.

Pipeline per 384-sample frame at 32 kHz (8 kHz call audio is upsampled
x4 with the repo's polyphase resampler; in this port, the PyTorch
``dsp/fir.py::polyphase_resample`` on ``default_device()``, the one
change from sdrtrunk_tpu/audio/mpeg.py):
  * 32-band PQMF analysis: 512-tap prototype (designed here with a
    Kaiser-windowed sinc at the standard cutoff pi/64 — the ISO Table
    C.1 window is a near-PQMF design of the same shape; an analysis
    prototype mismatch affects only reconstruction SNR, never bitstream
    validity) -> 12 subband samples x 32 subbands
  * per-subband scalefactor from the ISO 2^(1 - i/3) ladder (6-bit index)
  * uniform mid-rise quantization at a fixed 5-bit depth in every
    subband (allocation code 4), which exactly fits the 192 kbps mono
    frame budget: 2304 bits = 32 header + 128 allocation + 192
    scalefactors + 1920 sample bits + 32 ancillary
  * Layer I bitstream packing: sync 0xFFF, ID 1, layer '11',
    bitrate index 9 (192k), sampling frequency '10' (32 kHz),
    single-channel mode
"""
from __future__ import annotations

import numpy as np

from .segments import AudioSegment

__all__ = ["MpegLayer1Encoder", "mpeg_layer1_encoder",
           "MpegLayer2Encoder", "mpeg_layer2_encoder"]

SUBBANDS = 32
GRANULES = 12
FRAME_SAMPLES = SUBBANDS * GRANULES        # 384
SAMPLE_RATE = 32000.0
BITRATE = 192000
FRAME_BYTES = 12 * BITRATE // 32000 * 4    # slots * 4 bytes = 288
QUANT_BITS = 5                             # every subband, alloc code 4

# scalefactor ladder: index i -> 2.0 * 2^(-i/3), i in [0, 62]
# (ISO 11172-3 Table B.1)
_SCALEFACTORS = 2.0 * np.power(2.0, -np.arange(63) / 3.0)


def _upsample(pcm: np.ndarray, taps: np.ndarray, up: int) -> np.ndarray:
    """PCM -> x up with the port's polyphase resampler, as one (1, n)
    block on ``default_device()`` (the reference runs its resample on its
    default backend)."""
    import torch

    from .. import resolve_device
    from ..dsp import fir
    dev = resolve_device(None)
    x = torch.as_tensor(pcm, device=dev)[None]
    return fir.polyphase_resample(
        x, torch.as_tensor(taps, device=dev), up, 1)[0].cpu().numpy()


def _prototype(taps: int = 512) -> np.ndarray:
    """512-tap PQMF analysis window, cutoff pi/64 (1/2 subband).

    Includes the (-1)^(i//64) block-sign pattern the ISO C table bakes
    in: the 512->64 fold relies on cos((2k+1)(j+64i-16)pi/64) =
    (-1)^i cos((2k+1)(j-16)pi/64), so the window must carry the (-1)^i
    (without it every tone aliases across even-spaced subbands)."""
    n = np.arange(taps)
    x = (n - (taps - 1) / 2.0) / 64.0
    h = np.sinc(x / 2.0) * np.kaiser(taps, 9.0)
    h = h / np.sum(h)
    signs = np.where((n // 64) % 2 == 1, -1.0, 1.0)
    return (h * signs).astype(np.float64)


class MpegLayer1Encoder:
    """Streaming Layer I encoder; feed PCM at 8 kHz, emit whole frames."""

    def __init__(self, pcm_rate: float = 8000.0):
        from ..dsp import fir
        self.pcm_rate = float(pcm_rate)
        self.up = int(round(SAMPLE_RATE / pcm_rate))
        if self.up * pcm_rate != SAMPLE_RATE:
            raise ValueError("pcm rate must divide 32 kHz")
        self._resample_taps = np.asarray(
            fir.resample_taps(self.up, 1), np.float32)
        self._proto = _prototype()
        # analysis matrixing M[k, j] = cos((2k+1)(j-16)pi/64)
        k = np.arange(SUBBANDS)[:, None]
        j = np.arange(64)[None, :]
        self._mat = np.cos((2 * k + 1) * (j - 16) * np.pi / 64.0)
        self._window_buf = np.zeros(512, np.float64)
        self._pcm_carry = np.zeros(0, np.float32)

    # ------------------------------------------------------ analysis

    def _analyze(self, x32: np.ndarray) -> np.ndarray:
        """32 kHz PCM (multiple of 384) -> (groups, 12, 32) subbands."""
        out = np.empty((len(x32) // SUBBANDS, SUBBANDS))
        buf = self._window_buf
        # the fold-and-matrix path has amplitude gain window_gain/2 for a
        # subband-center tone; gain=2 makes subband amplitude == input
        # amplitude (keeps peaks inside the 2.0 scalefactor ceiling)
        gain = 2.0
        for i in range(len(x32) // SUBBANDS):
            buf = np.concatenate([x32[i * 32:(i + 1) * 32][::-1], buf[:480]])
            z = buf * self._proto * gain
            y = z.reshape(8, 64).sum(axis=0)
            out[i] = self._mat @ y
        self._window_buf = buf
        return out.reshape(-1, GRANULES, SUBBANDS)

    # ------------------------------------------------------ bitstream

    @staticmethod
    def _header() -> list[int]:
        bits = []
        bits += [1] * 12                      # sync
        bits += [1]                           # ID: MPEG-1
        bits += [1, 1]                        # layer I = '11'
        bits += [1]                           # protection: none
        bits += [1, 0, 0, 1]                  # bitrate index 9 -> 192k
        bits += [1, 0]                        # 32 kHz
        bits += [0]                           # padding
        bits += [0]                           # private
        bits += [1, 1]                        # mode: single channel
        bits += [0, 0]                        # mode extension
        bits += [0]                           # copyright
        bits += [1]                           # original
        bits += [0, 0]                        # emphasis: none
        return bits

    def _encode_frame(self, granules: np.ndarray) -> bytes:
        """granules: (12, 32) subband samples -> one 288-byte frame."""
        bits = self._header()
        # allocation: code = QUANT_BITS - 1 for every subband
        alloc_code = QUANT_BITS - 1
        for _ in range(SUBBANDS):
            bits += [(alloc_code >> b) & 1 for b in (3, 2, 1, 0)]
        # scalefactors: smallest ladder entry >= peak per subband
        peaks = np.abs(granules).max(axis=0)              # (32,)
        sf_idx = np.searchsorted(-_SCALEFACTORS, -peaks, side="right")
        sf_idx = np.clip(sf_idx - 1, 0, 62)
        sf_idx = np.where(peaks >= _SCALEFACTORS[0], 0, sf_idx)
        for idx in sf_idx:
            bits += [(int(idx) >> b) & 1 for b in range(5, -1, -1)]
        # samples: quantize onto the ISO Layer-I requantization grid so a
        # third-party decoder's s'' = (2^nb/(2^nb-1)) * (s''' + 2^(1-nb))
        # (11172-3 2.4.3.3) reproduces the value exactly: grid points are
        # s_c = (2c + 2 - 2^nb)/(2^nb - 1), c in [0, 2^nb - 1]
        levels = (1 << QUANT_BITS) - 1
        scaled = granules / _SCALEFACTORS[sf_idx][None, :]
        codes = np.clip(np.round(scaled * levels * 0.5
                                 + (1 << (QUANT_BITS - 1)) - 1
                                 ).astype(int), 0, levels)
        for g in range(GRANULES):
            for sb in range(SUBBANDS):
                c = int(codes[g, sb])
                bits += [(c >> b) & 1
                         for b in range(QUANT_BITS - 1, -1, -1)]
        # pad with ancillary zeros to the fixed frame length
        bits += [0] * (FRAME_BYTES * 8 - len(bits))
        return np.packbits(np.asarray(bits, np.uint8)).tobytes()

    # ------------------------------------------------------ public

    def encode(self, pcm: np.ndarray) -> bytes:
        """PCM float32 at pcm_rate -> whole MPEG frames (remainder PCM is
        carried into the next call)."""
        pcm = np.concatenate([self._pcm_carry,
                              np.asarray(pcm, np.float32)])
        frame_pcm = FRAME_SAMPLES // self.up      # input samples / frame
        n_frames = len(pcm) // frame_pcm
        self._pcm_carry = pcm[n_frames * frame_pcm:]
        if n_frames == 0:
            return b""
        usable = pcm[:n_frames * frame_pcm]
        x32 = _upsample(usable, self._resample_taps, self.up)
        frames = self._analyze(np.clip(x32, -1.0, 1.0))
        return b"".join(self._encode_frame(f) for f in frames)

    def flush(self) -> bytes:
        """Zero-pad the carry to a final whole frame."""
        if not len(self._pcm_carry):
            return b""
        frame_pcm = FRAME_SAMPLES // self.up
        pad = (-len(self._pcm_carry)) % frame_pcm
        return self.encode(np.zeros(pad, np.float32))


def mpeg_layer1_encoder(segment: AudioSegment) -> bytes:
    """AudioStreamingManager encoder hook: one AudioSegment -> MPEG
    frames (the MP3AudioConverter.convert role)."""
    enc = MpegLayer1Encoder(pcm_rate=segment.sample_rate)
    return enc.encode(segment.samples) + enc.flush()


# ===================================================== Layer II ("MP2")

L2_GRANULES = 36                            # 3 parts x 12
L2_FRAME_SAMPLES = SUBBANDS * L2_GRANULES   # 1152
L2_BITRATE = 96000
# slots = 144 * bitrate / fs, exact at 96k/32k -> 432 bytes, no padding
L2_FRAME_BYTES = 144 * L2_BITRATE // 32000
L2_QUANT_BITS = 10                          # steps 1023, non-grouped
L2_CODED_SUBBANDS = 8                       # 0..4 kHz; 8 kHz voice has
#                                             nothing above (alloc 0)

# ISO 11172-3 Table B.2b (32 kHz at >= 96 kbps mono), allocation-index
# widths per subband and the class lists needed for our fixed scheme:
#   sb 0-10: 4-bit alloc; sb 11-22: 3-bit; sb 23-29: 2-bit
# steps lists: sb 0-2  -> 3,7,15,31,63,127,255,511,1023,... (1023 @ 9)
#              sb 3-10 -> 3,5,7,9,15,31,63,127,255,511,1023 (1023 @ 11)
_L2_ALLOC_WIDTH = [4] * 11 + [3] * 12 + [2] * 7          # 30 subbands
_L2_ALLOC_1023 = {sb: (9 if sb < 3 else 11) for sb in range(11)}


class MpegLayer2Encoder:
    """Streaming MPEG-1 Audio **Layer II** encoder (mono, 32 kHz,
    96 kbps) — the closest in-repo step toward the reference's LAME MP3
    (audio/convert/MP3AudioConverter.java): Layer II shares MP3's frame
    length (1152 samples) and header family, streams as audio/mpeg, and
    every MPEG audio decoder handles it ("MP2").

    Fixed allocation scheme sized to the voice path: subbands 0-7 carry
    10-bit (1023-step, non-grouped) samples with all three scalefactors
    transmitted (scfsi 0); subbands 8-29 get allocation 0 — 8 kHz call
    audio upsampled x4 has no content above 4 kHz by construction.
    Budget: 3456 = 32 header + 94 allocation + 16 scfsi + 144
    scalefactors + 2880 samples + 290 ancillary zeros."""

    def __init__(self, pcm_rate: float = 8000.0):
        self._l1 = MpegLayer1Encoder(pcm_rate=pcm_rate)   # PQMF + resample
        self._pcm_carry = np.zeros(0, np.float32)

    @staticmethod
    def _header() -> list[int]:
        bits = []
        bits += [1] * 12                      # sync
        bits += [1]                           # ID: MPEG-1
        bits += [1, 0]                        # layer II = '10'
        bits += [1]                           # protection: none
        bits += [0, 1, 1, 0]                  # bitrate index 6 -> 96k
        bits += [1, 0]                        # 32 kHz
        bits += [0]                           # padding
        bits += [0]                           # private
        bits += [1, 1]                        # mode: single channel
        bits += [0, 0]                        # mode extension
        bits += [0]                           # copyright
        bits += [1]                           # original
        bits += [0, 0]                        # emphasis: none
        return bits

    def _encode_frame(self, granules: np.ndarray) -> bytes:
        """granules: (36, 32) subband samples -> one 432-byte frame."""
        bits = self._header()
        # allocation (Table B.2b widths); 1023-step class for coded
        # subbands, 0 for the rest
        for sb in range(30):
            w = _L2_ALLOC_WIDTH[sb]
            code = _L2_ALLOC_1023[sb] if sb < L2_CODED_SUBBANDS else 0
            bits += [(code >> b) & 1 for b in range(w - 1, -1, -1)]
        # scfsi: '00' = all three scalefactors transmitted
        bits += [0, 0] * L2_CODED_SUBBANDS
        # scalefactors: one per 12-granule part per coded subband
        parts = granules.reshape(3, 12, SUBBANDS)
        peaks = np.abs(parts).max(axis=1)                  # (3, 32)
        sf_idx = np.searchsorted(-_SCALEFACTORS, -peaks, side="right")
        sf_idx = np.clip(sf_idx - 1, 0, 62)
        sf_idx = np.where(peaks >= _SCALEFACTORS[0], 0, sf_idx)
        for sb in range(L2_CODED_SUBBANDS):
            for p in range(3):
                bits += [(int(sf_idx[p, sb]) >> b) & 1
                         for b in range(5, -1, -1)]
        # samples: same ISO requantization grid as Layer I at nb=10
        # (steps 2^nb - 1, MSB-inversion convention), three consecutive
        # samples per subband per granule
        levels = (1 << L2_QUANT_BITS) - 1
        scale = _SCALEFACTORS[sf_idx]                      # (3, 32)
        scaled = parts / scale[:, None, :]
        codes = np.clip(np.round(
            scaled * levels * 0.5 + (1 << (L2_QUANT_BITS - 1)) - 1
        ).astype(int), 0, levels).reshape(36, SUBBANDS)
        for gr in range(12):
            for sb in range(L2_CODED_SUBBANDS):
                for r in range(3 * gr, 3 * gr + 3):
                    cc = int(codes[r, sb])
                    bits += [(cc >> b) & 1
                             for b in range(L2_QUANT_BITS - 1, -1, -1)]
        bits += [0] * (L2_FRAME_BYTES * 8 - len(bits))
        return np.packbits(np.asarray(bits, np.uint8)).tobytes()

    def encode(self, pcm: np.ndarray) -> bytes:
        l1 = self._l1
        pcm = np.concatenate([self._pcm_carry,
                              np.asarray(pcm, np.float32)])
        frame_pcm = L2_FRAME_SAMPLES // l1.up
        n_frames = len(pcm) // frame_pcm
        self._pcm_carry = pcm[n_frames * frame_pcm:]
        if n_frames == 0:
            return b""
        usable = pcm[:n_frames * frame_pcm]
        x32 = _upsample(usable, l1._resample_taps, l1.up)
        sub = l1._analyze(np.clip(x32, -1.0, 1.0))   # (n*3, 12, 32)
        frames = sub.reshape(n_frames, L2_GRANULES, SUBBANDS)
        return b"".join(self._encode_frame(f) for f in frames)

    def flush(self) -> bytes:
        if not len(self._pcm_carry):
            return b""
        frame_pcm = L2_FRAME_SAMPLES // self._l1.up
        pad = (-len(self._pcm_carry)) % frame_pcm
        return self.encode(np.zeros(pad, np.float32))


def mpeg_layer2_encoder(segment: AudioSegment) -> bytes:
    """AudioStreamingManager encoder hook, Layer II variant."""
    enc = MpegLayer2Encoder(pcm_rate=segment.sample_rate)
    return enc.encode(segment.samples) + enc.flush()
