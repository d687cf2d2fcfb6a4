"""Sample sources: tuner abstraction, format converters, synthetic & file
backends (reference layer L0, source/ — SURVEY.md §2.4)."""
from .converters import (  # noqa: F401
    rtl_bytes_to_iq, signed_bytes_to_iq, airspy_unpacked_to_floats,
    airspy_packed_to_floats, pcm16_to_iq, interleave_to_complex)
from .tuner import (  # noqa: F401
    SourceEventType, SourceEvent, TunerSpec, TunerController, TunerManager,
    TunerUnavailable)
from .test_tuner import TestTuner  # noqa: F401
from .recording import RecordingTuner, ComplexWaveSource  # noqa: F401
from .usb import (  # noqa: F401
    ControlTransfer, RecordingTransport, TransferProcessor, TransferState,
    UsbError)
from .rtl2832 import RTL2832Controller, R820TController  # noqa: F401
from .hackrf import HackRFController  # noqa: F401
from .airspy import AirspyController  # noqa: F401
