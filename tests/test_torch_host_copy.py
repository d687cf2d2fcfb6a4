"""The port's copy of the framework-free host layer stays byte for byte
equal to the JAX package's.

The port imports nothing of sdrtrunk_tpu. What it needs of the host layer
(the protocol framers and parsers, the runtime's decoder states, bank
processors, bank worker process, events and traffic manager, the tuner's
source events, the audio segments and MBE module, the wave reader, the
signal generators, and the filter design, window and interpolator
helpers; and for the application: the playlist config and importer, the
monitor session, the map service, alias actions and heartbeat, audio
streaming, the service clients, the native ingest bindings, the DFT
processor and instrument taps, and every sample source) is copied to the
same relative path under sdrtrunk_tpu_torch/. MANIFEST lists every copy.
A fix to the host layer must change the original, the copy and, where a
file is added or removed, the manifest together: the port and the
reference then keep giving the same answers, the known faults of the host
layer included (ROADMAP Queue 3, "Waiting").
"""
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "sdrtrunk_tpu"
PORT = ROOT / "sdrtrunk_tpu_torch"

# paths relative to each package's root
MANIFEST = (
    "audio/__init__.py",
    "audio/duplicate.py",
    "audio/mbe.py",
    "audio/playback.py",
    "audio/recorder.py",
    "audio/segments.py",
    "audio/shoutcast_v2.py",
    "audio/streaming.py",
    "config.py",
    "dsp/design.py",
    "dsp/dft_processor.py",
    "dsp/instrument.py",
    "dsp/interpolator.py",
    "dsp/windows.py",
    "io/__init__.py",
    "io/native.py",
    "io/wave.py",
    "map_service.py",
    "monitor.py",
    "playlist_import.py",
    "protocol/__init__.py",
    "protocol/auxdec/__init__.py",
    "protocol/auxdec/fleetsync2.py",
    "protocol/auxdec/lj1200.py",
    "protocol/auxdec/mdc1200.py",
    "protocol/auxdec/tait1200.py",
    "protocol/bits.py",
    "protocol/dmr/__init__.py",
    "protocol/dmr/bankframer.py",
    "protocol/dmr/burst.py",
    "protocol/dmr/csbk.py",
    "protocol/dmr/csbk_vendor.py",
    "protocol/dmr/data.py",
    "protocol/dmr/framer.py",
    "protocol/dmr/lc.py",
    "protocol/dmr/packet.py",
    "protocol/dmr/sync.py",
    "protocol/edac/__init__.py",
    "protocol/edac/bch.py",
    "protocol/edac/bptc.py",
    "protocol/edac/crc.py",
    "protocol/edac/galois.py",
    "protocol/edac/golay.py",
    "protocol/edac/hamming.py",
    "protocol/edac/rs.py",
    "protocol/edac/syndrome.py",
    "protocol/edac/trellis.py",
    "protocol/framer.py",
    "protocol/ip/__init__.py",
    "protocol/ip/ars.py",
    "protocol/ip/cellocator.py",
    "protocol/ip/lrrp.py",
    "protocol/ip/packets.py",
    "protocol/ip/xcmp.py",
    "protocol/ltr/__init__.py",
    "protocol/ltr/ltrnet.py",
    "protocol/ltr/messages.py",
    "protocol/mpt1327.py",
    "protocol/p25p1/__init__.py",
    "protocol/p25p1/ambtc.py",
    "protocol/p25p1/bankframer.py",
    "protocol/p25p1/duid.py",
    "protocol/p25p1/framer.py",
    "protocol/p25p1/hdu.py",
    "protocol/p25p1/lc.py",
    "protocol/p25p1/ldu.py",
    "protocol/p25p1/messages.py",
    "protocol/p25p1/nid.py",
    "protocol/p25p1/pdu.py",
    "protocol/p25p1/sndcp.py",
    "protocol/p25p1/tsbk.py",
    "protocol/p25p1/tsbk_vendor.py",
    "protocol/p25p2/__init__.py",
    "protocol/p25p2/bankframer.py",
    "protocol/p25p2/framer.py",
    "protocol/p25p2/isch.py",
    "protocol/p25p2/mac.py",
    "protocol/p25p2/scrambler.py",
    "protocol/p25p2/timeslot.py",
    "protocol/passport.py",
    "runtime/alias_actions.py",
    "runtime/aliases.py",
    "runtime/bank_processor.py",
    "runtime/bank_worker.py",
    "runtime/dmr_state.py",
    "runtime/eventlog.py",
    "runtime/events.py",
    "runtime/heartbeat.py",
    "runtime/identifiers.py",
    "runtime/metrics.py",
    "runtime/p25_state.py",
    "runtime/p25p2_state.py",
    "runtime/processors.py",
    "runtime/rotation.py",
    "runtime/state.py",
    "runtime/traffic.py",
    "service/__init__.py",
    "service/radioreference.py",
    "signal/__init__.py",
    "signal/generators.py",
    "sources/__init__.py",
    "sources/airspy.py",
    "sources/converters.py",
    "sources/e4k.py",
    "sources/fcd.py",
    "sources/hackrf.py",
    "sources/libusb.py",
    "sources/recording.py",
    "sources/rtl2832.py",
    "sources/rtl_live.py",
    "sources/soundcard.py",
    "sources/test_tuner.py",
    "sources/tuner.py",
    "sources/usb.py",
)
# directories whose every file is a copy, but for the files of REWRITTEN
COPIED_TREES = ("audio", "io", "protocol", "service", "signal", "sources")
# files of a copied tree that the port rewrites: audio/mpeg.py is the
# reference's but for its resample, which runs on the port's PyTorch
# polyphase_resample (tests/test_torch_mpeg.py holds it to the reference)
REWRITTEN = ("audio/mpeg.py",)


@pytest.mark.parametrize("rel", MANIFEST)
def test_copy_equals_original(rel):
    assert (PORT / rel).read_bytes() == (REFERENCE / rel).read_bytes(), \
        f"sdrtrunk_tpu_torch/{rel} differs from sdrtrunk_tpu/{rel}"


def test_manifest_lists_every_copy():
    """Every file of a copied tree is in the manifest or is one of the
    REWRITTEN files, so none is edited or added in the port alone."""
    found = {str(p.relative_to(PORT)) for tree in COPIED_TREES
             for p in (PORT / tree).rglob("*.py")}
    assert found == {rel for rel in MANIFEST
                     if rel.split("/")[0] in COPIED_TREES} | set(REWRITTEN)
    assert len(set(MANIFEST)) == len(MANIFEST)
    assert not set(REWRITTEN) & set(MANIFEST)


@pytest.mark.parametrize("rel", REWRITTEN)
def test_rewritten_file_differs_from_its_original(rel):
    """A rewritten file of a copied tree exists beside its original and is
    not a copy (a copy belongs in MANIFEST)."""
    assert (REFERENCE / rel).exists()
    assert (PORT / rel).read_bytes() != (REFERENCE / rel).read_bytes()
