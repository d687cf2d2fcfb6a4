"""ctypes binding to libusb-1.0: device discovery + control/bulk
transport for the hardware tuner controllers.

Role of the reference's usb4java/libusb4java JNI layer plus
TunerManager's discovery pass (source/tuner/TunerManager.java:108-188:
LibUsb.init -> getDeviceList -> descriptor -> TunerClass.valueOf -> open
and claim) and USBTransferProcessor's streaming loop with stall recovery
(USBTransferProcessor.java:235 clearHalt, :265-300 resubmission). The
control-plane state machines in sources/{rtl2832,hackrf,airspy}.py
program against the UsbTransport protocol (sources/usb.py); this module
provides the real transport, and `BulkStreamer` feeds the ingest ring
from a bulk IN endpoint on a reader thread, restarting through
clear_halt on stalls via the TransferProcessor state machine.

Everything degrades gracefully: `available()` is False when the shared
library is absent, and all raw calls sit behind small wrappers so tests
can inject a fake lib.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import threading
from dataclasses import dataclass

from .usb import TransferProcessor, UsbError

__all__ = ["available", "LibUsbContext", "LibUsbTransport", "BulkStreamer",
           "DeviceInfo", "TUNER_CLASSES", "classify", "discover_tuners"]

_LIBUSB_SUCCESS = 0
_LIBUSB_ERROR_PIPE = -9          # endpoint halted (stall)
_ENDPOINT_IN = 0x80
_VENDOR_OUT = 0x40               # bmRequestType: vendor | host-to-device
_VENDOR_IN = 0xC0


class _DeviceDescriptor(ctypes.Structure):
    _fields_ = [
        ("bLength", ctypes.c_uint8),
        ("bDescriptorType", ctypes.c_uint8),
        ("bcdUSB", ctypes.c_uint16),
        ("bDeviceClass", ctypes.c_uint8),
        ("bDeviceSubClass", ctypes.c_uint8),
        ("bDeviceProtocol", ctypes.c_uint8),
        ("bMaxPacketSize0", ctypes.c_uint8),
        ("idVendor", ctypes.c_uint16),
        ("idProduct", ctypes.c_uint16),
        ("bcdDevice", ctypes.c_uint16),
        ("iManufacturer", ctypes.c_uint8),
        ("iProduct", ctypes.c_uint8),
        ("iSerialNumber", ctypes.c_uint8),
        ("bNumConfigurations", ctypes.c_uint8),
    ]


_lib_cache: list = []


def _load():
    if _lib_cache:
        return _lib_cache[0]
    path = (ctypes.util.find_library("usb-1.0")
            or ctypes.util.find_library("libusb-1.0"))
    lib = ctypes.CDLL(path) if path else None
    if lib is not None:
        lib.libusb_get_device_list.restype = ctypes.c_ssize_t
        lib.libusb_open_device_with_vid_pid.restype = ctypes.c_void_p
        lib.libusb_get_bus_number.restype = ctypes.c_uint8
        lib.libusb_get_device_address.restype = ctypes.c_uint8
    _lib_cache.append(lib)
    return lib


def available() -> bool:
    return _load() is not None


@dataclass(frozen=True)
class DeviceInfo:
    vendor_id: int
    product_id: int
    bus: int
    address: int

    def __str__(self) -> str:
        return (f"{self.vendor_id:04X}:{self.product_id:04X} "
                f"bus {self.bus} addr {self.address}")


# (vendor, product) -> (tuner kind, label); the RTL2832/HackRF/Airspy/FCD
# subset of TunerClass.java:27-60 that this repo has controllers for
TUNER_CLASSES = {
    (0x0BDA, 0x2832): ("rtl2832", "RTL2832 SDR"),
    (0x0BDA, 0x2838): ("rtl2832", "RTL2832 SDR"),
    (0x1D50, 0x60A1): ("airspy", "Airspy"),
    (0x1D50, 0x6089): ("hackrf", "HackRF One"),
    (0x1D50, 0x604B): ("hackrf", "HackRF Jawbreaker"),
    (0x1D50, 0xCC15): ("hackrf", "Rad1o"),
    (0x04D8, 0xFB56): ("fcd", "Funcube Dongle Pro"),
    (0x04D8, 0xFB31): ("fcd", "Funcube Dongle Pro Plus"),
}


def classify(vendor_id: int, product_id: int) -> tuple[str, str] | None:
    """TunerClass.valueOf(vendor, product) equivalent."""
    return TUNER_CLASSES.get((vendor_id & 0xFFFF, product_id & 0xFFFF))


class LibUsbContext:
    """libusb_init/exit + device enumeration."""

    def __init__(self, lib=None):
        self._lib = lib if lib is not None else _load()
        if self._lib is None:
            raise UsbError("libusb-1.0 not available")
        self._ctx = ctypes.c_void_p()
        rc = self._lib.libusb_init(ctypes.byref(self._ctx))
        if rc != _LIBUSB_SUCCESS:
            raise UsbError(f"libusb_init failed: {rc}")

    def devices(self) -> list[DeviceInfo]:
        dev_list = ctypes.POINTER(ctypes.c_void_p)()
        n = self._lib.libusb_get_device_list(self._ctx,
                                             ctypes.byref(dev_list))
        if n < 0:
            raise UsbError(f"libusb_get_device_list failed: {n}")
        out = []
        try:
            for i in range(n):
                desc = _DeviceDescriptor()
                rc = self._lib.libusb_get_device_descriptor(
                    dev_list[i], ctypes.byref(desc))
                if rc != _LIBUSB_SUCCESS:
                    continue
                out.append(DeviceInfo(
                    vendor_id=desc.idVendor, product_id=desc.idProduct,
                    bus=self._lib.libusb_get_bus_number(dev_list[i]),
                    address=self._lib.libusb_get_device_address(
                        dev_list[i])))
        finally:
            self._lib.libusb_free_device_list(dev_list, 1)
        return out

    def close(self) -> None:
        if self._ctx:
            self._lib.libusb_exit(self._ctx)
            self._ctx = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def discover_tuners(ctx: LibUsbContext | None = None) -> list[dict]:
    """Enumerate attached devices and classify known tuners
    (TunerManager.java:122-188 discovery loop)."""
    own = ctx is None
    if own:
        ctx = LibUsbContext()
    try:
        found = []
        for dev in ctx.devices():
            cls = classify(dev.vendor_id, dev.product_id)
            if cls is not None:
                found.append({"device": dev, "kind": cls[0],
                              "label": cls[1]})
        return found
    finally:
        if own:
            ctx.close()


class LibUsbTransport:
    """UsbTransport implementation over an open device handle: vendor
    control transfers + bulk reads + clear_halt."""

    def __init__(self, vendor_id: int, product_id: int,
                 interface: int = 0, ctx: LibUsbContext | None = None,
                 lib=None, timeout_ms: int = 1000):
        self._lib = lib if lib is not None else _load()
        if self._lib is None:
            raise UsbError("libusb-1.0 not available")
        self._ctx = ctx if ctx is not None else LibUsbContext(self._lib)
        self._own_ctx = ctx is None
        self.timeout_ms = timeout_ms
        self.interface = interface
        handle = self._lib.libusb_open_device_with_vid_pid(
            self._ctx._ctx, vendor_id, product_id)
        if not handle:
            raise UsbError(f"device {vendor_id:04X}:{product_id:04X} "
                           "not found or not openable")
        self._handle = ctypes.c_void_p(handle)
        # detach an attached kernel driver, then claim (TunerManager's
        # open path)
        if hasattr(self._lib, "libusb_kernel_driver_active") and \
                self._lib.libusb_kernel_driver_active(
                    self._handle, interface) == 1:
            self._lib.libusb_detach_kernel_driver(self._handle, interface)
        rc = self._lib.libusb_claim_interface(self._handle, interface)
        if rc != _LIBUSB_SUCCESS:
            raise UsbError(f"claim_interface failed: {rc}")

    # --- UsbTransport protocol ---

    def control_out(self, request: int, value: int, index: int,
                    data: bytes = b"") -> None:
        buf = ctypes.create_string_buffer(bytes(data), max(len(data), 1))
        rc = self._lib.libusb_control_transfer(
            self._handle, _VENDOR_OUT, request, value, index, buf,
            len(data), self.timeout_ms)
        if rc < 0:
            raise UsbError(f"control_out failed: {rc}")

    def control_in(self, request: int, value: int, index: int,
                   length: int) -> bytes:
        buf = ctypes.create_string_buffer(length)
        rc = self._lib.libusb_control_transfer(
            self._handle, _VENDOR_IN, request, value, index, buf,
            length, self.timeout_ms)
        if rc < 0:
            raise UsbError(f"control_in failed: {rc}")
        return buf.raw[:rc]

    # --- streaming ---

    def bulk_read(self, endpoint: int, length: int) -> bytes:
        """One synchronous bulk IN transfer; raises UsbError with
        .stalled=True on a pipe error so the streamer can clear_halt."""
        buf = ctypes.create_string_buffer(length)
        got = ctypes.c_int(0)
        rc = self._lib.libusb_bulk_transfer(
            self._handle, endpoint | _ENDPOINT_IN, buf, length,
            ctypes.byref(got), self.timeout_ms)
        if rc != _LIBUSB_SUCCESS:
            err = UsbError(f"bulk_transfer failed: {rc}")
            err.stalled = (rc == _LIBUSB_ERROR_PIPE)
            raise err
        return buf.raw[:got.value]

    def clear_halt(self, endpoint: int) -> None:
        self._lib.libusb_clear_halt(self._handle, endpoint | _ENDPOINT_IN)

    def close(self) -> None:
        if self._handle:
            self._lib.libusb_release_interface(self._handle,
                                               self.interface)
            self._lib.libusb_close(self._handle)
            self._handle = ctypes.c_void_p()
        if self._own_ctx:
            self._ctx.close()


class BulkStreamer:
    """Reader-thread bulk streaming with stall recovery — the
    USBTransferProcessor role: continuous bulk IN reads feed `sink`
    (e.g. the native ingest ring's write + a sample converter); a stall
    clears the endpoint halt and resubmits; repeated failures walk the
    TransferProcessor state machine into ERROR."""

    def __init__(self, transport, endpoint: int, sink,
                 transfer_bytes: int = 262144):
        self.transport = transport
        self.endpoint = endpoint
        self.sink = sink
        self.transfer_bytes = transfer_bytes
        self.processor = TransferProcessor(submit=lambda: True)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self) -> None:
        self.processor.start()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="usb-bulk-streamer")
        self._thread.start()

    def _run(self) -> None:
        from .usb import TransferState
        while not self._stop.is_set() and \
                self.processor.state == TransferState.RUNNING:
            try:
                data = self.transport.bulk_read(self.endpoint,
                                                self.transfer_bytes)
            except UsbError as e:
                if getattr(e, "stalled", False):
                    # LibUsb.clearHalt + resubmit
                    self.transport.clear_halt(self.endpoint)
                self.processor.on_complete(ok=False)
                continue
            if data:
                self.sink(data)
            self.processor.on_complete(ok=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.processor.stop()
