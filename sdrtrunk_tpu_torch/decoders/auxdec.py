"""Auxiliary decoder chains: 8 kHz demodulated FM audio -> messages (port
of sdrtrunk_tpu/decoders/auxdec.py).

The reference attaches these to analog voice channels alongside the
primary decoder (module/decode/DecoderFactory.java:398-425; auxiliary
decoders run on the demodulated audio stream). Each chain is the shared
AFSK1200 correlation demodulator on the device plus a host-side framer and
parser, the same device/host split as the trunked protocols.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import tree_map
from ..dsp.afsk import AFSK1200Demodulator
from ..protocol.auxdec import (Fleetsync2Framer, LJ1200Framer, MDCFramer,
                               Tait1200Framer)

__all__ = ["AuxDecoder", "AUX_PROTOCOLS"]

AUX_PROTOCOLS = ("fleetsync2", "mdc1200", "lj1200", "tait1200")

_FRAMERS = {
    "fleetsync2": Fleetsync2Framer,
    "mdc1200": MDCFramer,
    "lj1200": LJ1200Framer,
    "tait1200": Tait1200Framer,
}


class AuxDecoder:
    """One auxiliary protocol decoder over one channel's 8 kHz audio
    blocks.

    MDC-1200 uses the inverted slicer output (MDCDecoder.java:44,
    AFSK1200Decoder.Output.INVERTED); its framer NRZ-decodes internally.
    ``device=None`` is ``default_device()``: the copied channel processors
    build it without one (``runtime/processors.py`` ``add_aux``).
    """

    def __init__(self, protocol: str, device=None):
        if protocol not in _FRAMERS:
            raise ValueError(
                f"unknown aux protocol {protocol!r}; one of {AUX_PROTOCOLS}")
        self.protocol = protocol
        self.device = resolve_device(device)
        self.demod = AFSK1200Demodulator(invert=(protocol == "mdc1200"),
                                         device=self.device)
        self.framer = _FRAMERS[protocol]()
        self._state = self._init_state()

    def _init_state(self):
        return tree_map(lambda a: a[None].clone(), self.demod.init_state())

    def reset(self):
        self.framer.reset()
        self._state = self._init_state()

    def process(self, audio) -> list:
        """audio: float 8 kHz block (length multiple of 10) -> messages."""
        x = torch.as_tensor(np.asarray(audio, np.float32),
                            device=self.device)[None]
        bits, valid, self._state = self.demod.batched(x, self._state)
        return self.framer.process(bits[valid].cpu().numpy())
