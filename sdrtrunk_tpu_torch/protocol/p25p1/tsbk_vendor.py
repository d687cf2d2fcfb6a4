"""Vendor (MFID) TSBK message families: Motorola and Harris OSPs.

Real-world P25 systems are dominated by Motorola vendor opcodes (patch
groups, traffic-channel markers, CWID) riding the standard TSBK
transport with MFID 0x90 (Vendor.java:149) or 0xA4 for Harris
(Vendor.java:169). Field layouts mirror
module/decode/p25/phase1/message/tsbk/motorola/osp/*.java and
harris/osp/HarrisTDMASyncBroadcast.java; offsets below are args-relative
(absolute bit minus the 16-bit LB/P/OPCODE/MFID header).
"""
from __future__ import annotations

from ..bits import to_int

__all__ = ["MFID_MOTOROLA", "MFID_HARRIS", "MOTOROLA_OSP_NAMES",
           "HARRIS_OSP_NAMES", "vendor_opcode_name", "parse_vendor_args"]

MFID_MOTOROLA = 0x90
MFID_HARRIS = 0xA4

# tsbk/Opcode.java:167-183
MOTOROLA_OSP_NAMES = {
    0x00: "MOTOROLA_PATCH_GROUP_ADD",
    0x01: "MOTOROLA_PATCH_GROUP_DELETE",
    0x02: "MOTOROLA_PATCH_GROUP_CHANNEL_GRANT",
    0x03: "MOTOROLA_PATCH_GROUP_CHANNEL_GRANT_UPDATE",
    0x05: "MOTOROLA_TRAFFIC_CHANNEL_ID",
    0x07: "MOTOROLA_DENY_RESPONSE",
    0x09: "MOTOROLA_SYSTEM_LOADING",
    0x0B: "MOTOROLA_BASE_STATION_ID",
    0x0E: "MOTOROLA_CONTROL_CHANNEL_PLANNED_SHUTDOWN",
}
HARRIS_OSP_NAMES = {
    0x30: "HARRIS_TDMA_SYNC",
}

# patch group membership (PatchGroupAdd/Delete.java:38-41)
_PATCH_MEMBERS = [("patch_group", 0, 16), ("group_address_1", 16, 32),
                  ("group_address_2", 32, 48), ("group_address_3", 48, 64)]

_MOTOROLA_FIELDS: dict[int, list] = {
    0x00: _PATCH_MEMBERS,
    0x01: _PATCH_MEMBERS,
    # PatchGroupVoiceChannelGrant.java:43-48
    0x02: [("service_options", 0, 8), ("frequency_band", 8, 12),
           ("channel_number", 12, 24), ("patch_group", 24, 40),
           ("source_address", 40, 64)],
    # PatchGroupVoiceChannelGrantUpdate.java:41-46
    0x03: [("frequency_band_1", 0, 4), ("channel_number_1", 4, 16),
           ("patch_group_1", 16, 32), ("frequency_band_2", 32, 36),
           ("channel_number_2", 36, 48), ("patch_group_2", 48, 64)],
    # MotorolaDenyResponse.java:42-48
    0x07: [("additional_info_flag", 0, 1), ("service_type", 2, 8),
           ("reason", 8, 16), ("additional_info", 16, 40),
           ("target_address", 40, 64)],
    # MotorolaBaseStationId.java:38-47 (characters handled separately)
    0x0B: [("frequency_band", 48, 52), ("channel_number", 52, 64)],
}


def vendor_opcode_name(mfid: int, opcode: int) -> str | None:
    if mfid == MFID_MOTOROLA:
        return MOTOROLA_OSP_NAMES.get(opcode,
                                      f"MOTOROLA_OSP_{opcode:02X}")
    if mfid == MFID_HARRIS:
        return HARRIS_OSP_NAMES.get(opcode, f"HARRIS_OSP_{opcode:02X}")
    return None


def parse_vendor_args(mfid: int, opcode: int, args) -> dict | None:
    """Field dict for a vendor OSP, or None when the MFID is unhandled."""
    if mfid == MFID_MOTOROLA:
        fields = {name: to_int(args, lo, hi)
                  for name, lo, hi in _MOTOROLA_FIELDS.get(opcode, [])}
        if opcode == 0x0B:
            # CWID: eight 6-bit characters, chr(v + 43), 0 = absent
            # (MotorolaBaseStationId.getCharacter)
            chars = [to_int(args, 6 * i, 6 * i + 6) for i in range(8)]
            fields["cwid"] = "".join(chr(v + 43) for v in chars if v)
        return fields
    if mfid == MFID_HARRIS:
        return {}
    return None
