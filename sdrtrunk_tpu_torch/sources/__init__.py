"""Sample sources of the port: the tuner controller contract and its source
events (``tuner.py``, a byte-for-byte copy of the reference's). The rest of
the reference's ``sources`` package (format converters, recording and USB
backends) is not ported yet."""
from .tuner import (  # noqa: F401
    SourceEventType, SourceEvent, TunerSpec, TunerController, TunerManager,
    TunerUnavailable)
