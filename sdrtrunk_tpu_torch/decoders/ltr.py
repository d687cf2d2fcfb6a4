"""LTR-family and MPT1327 decoder chains on the device (port of
sdrtrunk_tpu/decoders/ltr.py): NBFM-demodulated 8 kHz audio -> bit slicer
-> sliced bits, which the host framers consume.

Reference chain: ltrstandard/LTRStandardDecoder.java wires the NBFM
demodulated audio into dsp/fsk/LTRDecoder.java at 8 kHz / 300 baud;
mpt1327/MPT1327Decoder.java into the 1200-baud AFSK correlator. Batched
over a (C, T) block of channels, state leaves with a leading C axis; a
call on one channel's 1-D block runs that path at C = 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..dsp.afsk import AFSK1200Demodulator
from ..dsp.fsk import LTRFSKDemodulator, LTRFSKState
from ..tree import per_channel
from .nbfm import NBFMConfig, NBFMDecoder

__all__ = ["LTRConfig", "LTRDecoder", "LTRLiveDecoder", "MPT1327LiveDecoder"]


@dataclass(frozen=True)
class LTRConfig:
    audio_rate: float = 8000.0
    symbol_rate: float = 300.0


class LTRDecoder(nn.Module):
    """Operates on demodulated FM audio (use NBFMDecoder upstream)."""

    def __init__(self, config: LTRConfig = LTRConfig(), device="cuda"):
        super().__init__()
        self.config = config
        self.fsk = LTRFSKDemodulator(sample_rate=config.audio_rate,
                                     symbol_rate=config.symbol_rate,
                                     device=device)

    def init_state(self) -> LTRFSKState:
        return self.fsk.init_state()

    def batched_call(self, audio: torch.Tensor, state: LTRFSKState):
        """(C, T) 8 kHz audio -> ({bits (C, T) int8, valid (C, T) bool},
        new state)."""
        bits, valid, new_state = self.fsk.batched(audio, state)
        return {"bits": bits, "valid": valid}, new_state

    def forward(self, audio: torch.Tensor, state: LTRFSKState):
        """One channel's 1-D audio block: ``batched_call`` at C = 1."""
        return per_channel(self.batched_call, audio, state)


class _LiveTrunkDecoder(nn.Module):
    """NBFM demodulation (voice audio and squelch gate) and a bit slicer
    over the same audio: the module list the reference wires for a
    running analog-trunking channel (decoder + audio module). ``slicer``
    names the demodulator submodule and its state key."""

    slicer: str

    def __init__(self, sample_rate: float, channel_bandwidth: float, demod,
                 device):
        super().__init__()
        self.nbfm = NBFMDecoder(NBFMConfig(sample_rate=sample_rate,
                                           bandwidth=channel_bandwidth),
                                device=device)
        self.up, self.down = self.nbfm.up, self.nbfm.down
        self.add_module(self.slicer, demod)

    def init_state(self) -> dict:
        """Fresh state for one channel (leaves without a channel axis)."""
        return {"nbfm": self.nbfm.init_state(),
                self.slicer: getattr(self, self.slicer).init_state()}

    def _slice(self, audio: torch.Tensor) -> torch.Tensor:
        """The part of a chunk's audio the slicer takes."""
        return audio

    def batched_call(self, x: torch.Tensor, state: dict):
        """(C, T) complex64 channel block -> ({audio (C, Ka) float32,
        audio_gate (C, Ka) bool, bits int8, valid bool}, new state); bits
        and valid are (C, Ka) for the FSK slicer and (C, Ka // 10 * 9) for
        the AFSK one."""
        out, nbfm_state = self.nbfm.batched_call(x, state["nbfm"])
        bits, valid, slicer_state = getattr(self, self.slicer).batched(
            self._slice(out["audio"]), state[self.slicer])
        return ({"audio": out["audio"], "audio_gate": out["audio_gate"],
                 "bits": bits, "valid": valid},
                {"nbfm": nbfm_state, self.slicer: slicer_state})

    def forward(self, x: torch.Tensor, state: dict):
        """One channel's 1-D block: ``batched_call`` at C = 1."""
        return per_channel(self.batched_call, x, state)


class LTRLiveDecoder(_LiveTrunkDecoder):
    """Full live LTR slot chain: NBFM demod + zero-crossing FSK slicer
    (ltrstandard/LTRStandardDecoder.java). Outputs the 8 kHz voice audio
    and the sliced sub-audible bits; the host framer and state layer
    consume them (runtime/processors.py LTRChannelProcessor). Also serves
    LTR-Net and Passport, which share the FSK physical layer
    (ltrnet/LTRNetDecoder.java, passport/PassportDecoder.java)."""

    slicer = "fsk"

    def __init__(self, sample_rate: float = 25000.0,
                 channel_bandwidth: float = 12500.0, device="cuda"):
        super().__init__(sample_rate, channel_bandwidth,
                         LTRFSKDemodulator(sample_rate=8000.0,
                                           symbol_rate=300.0, device=device),
                         device)


class MPT1327LiveDecoder(_LiveTrunkDecoder):
    """Live MPT1327 control/traffic slot: NBFM demod + 1200-baud AFSK
    correlator (mpt1327/MPT1327Decoder.java chain). The AFSK demodulator
    takes the chunk's audio cut to a multiple of 10 samples (its
    resampler's ``down``), as the reference does: a chunk whose audio
    length is not such a multiple drops the rest and slips the timing."""

    slicer = "afsk"

    def __init__(self, sample_rate: float = 25000.0,
                 channel_bandwidth: float = 12500.0, device="cuda"):
        super().__init__(sample_rate, channel_bandwidth,
                         AFSK1200Demodulator(device=device), device)

    def _slice(self, audio: torch.Tensor) -> torch.Tensor:
        return audio[:, :audio.shape[1] // 10 * 10]
