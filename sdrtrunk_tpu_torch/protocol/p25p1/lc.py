"""P25 link control word (72 bits) parsing + construction.

Format (TIA-102.AABF; reference lc/LinkControlWord.java + lc/standard/*):
PF(1) SF(1) LCO(6) then opcode-specific fields. Opcode numbering follows
lc/LinkControlOpcode.java; field bit offsets are absolute within the
72-bit word, mirroring lc/standard/LC*.java.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bits import from_int, to_int

__all__ = ["LinkControl", "lc_parse", "lc_build_group_voice", "LCO_NAMES"]

LCO_NAMES = {
    0x00: "GROUP_VOICE_CHANNEL_USER",
    0x02: "GROUP_VOICE_CHANNEL_UPDATE",
    0x03: "UNIT_TO_UNIT_VOICE_CHANNEL_USER",
    0x04: "GROUP_VOICE_CHANNEL_UPDATE_EXPLICIT",
    0x05: "UNIT_TO_UNIT_ANSWER_REQUEST",
    0x06: "TELEPHONE_INTERCONNECT_VOICE_CHANNEL_USER",
    0x07: "TELEPHONE_INTERCONNECT_ANSWER_REQUEST",
    0x0F: "CALL_TERMINATION_OR_CANCELLATION",
    0x10: "GROUP_AFFILIATION_QUERY",
    0x11: "UNIT_REGISTRATION_COMMAND",
    0x12: "UNIT_AUTHENTICATION_COMMAND",
    0x13: "STATUS_QUERY",
    0x14: "STATUS_UPDATE",
    0x15: "MESSAGE_UPDATE",
    0x16: "CALL_ALERT",
    0x17: "EXTENDED_FUNCTION_COMMAND",
    0x18: "CHANNEL_IDENTIFIER_UPDATE",
    0x19: "CHANNEL_IDENTIFIER_UPDATE_EXPLICIT",
    0x20: "SYSTEM_SERVICE_BROADCAST",
    0x21: "SECONDARY_CONTROL_CHANNEL_BROADCAST",
    0x22: "ADJACENT_SITE_STATUS_BROADCAST",
    0x23: "RFSS_STATUS_BROADCAST",
    0x24: "NETWORK_STATUS_BROADCAST",
    0x25: "PROTECTION_PARAMETER_BROADCAST",
    0x26: "SECONDARY_CONTROL_CHANNEL_BROADCAST_EXPLICIT",
    0x27: "ADJACENT_SITE_STATUS_BROADCAST_EXPLICIT",
    0x28: "RFSS_STATUS_BROADCAST_EXPLICIT",
    0x29: "NETWORK_STATUS_BROADCAST_EXPLICIT",
}

# absolute bit offsets within the 72-bit word (lc/standard/LC*.java)
_LC_FIELDS: dict[int, list] = {
    0x00: [("mfid", 8, 16), ("service_options", 16, 24),
           ("group_address", 32, 48), ("source_address", 48, 72)],
    0x02: [("frequency_band_1", 8, 12), ("channel_number_1", 12, 24),
           ("group_address_1", 24, 40), ("frequency_band_2", 40, 44),
           ("channel_number_2", 44, 56), ("group_address_2", 56, 72)],
    0x03: [("mfid", 8, 16), ("service_options", 16, 24),
           ("target_address", 24, 48), ("source_address", 48, 72)],
    0x04: [("service_options", 16, 24), ("group_address", 24, 40),
           ("downlink_frequency_band", 40, 44),
           ("downlink_channel_number", 44, 56),
           ("uplink_frequency_band", 56, 60),
           ("uplink_channel_number", 60, 72)],
    0x05: [("service_options", 8, 16), ("target_address", 24, 48),
           ("source_address", 48, 72)],
    0x06: [("service_options", 16, 24), ("call_timer", 32, 48),
           ("address", 48, 72)],
    0x07: [(f"digit_{i + 1}", 8 + 4 * i, 12 + 4 * i) for i in range(10)]
          + [("target_address", 48, 72)],
    0x0F: [("mfid", 8, 16), ("source_address", 48, 72)],
    0x10: [("target_address", 24, 48), ("source_address", 48, 72)],
    0x11: [("wacn", 8, 28), ("system_id", 28, 40),
           ("target_address", 40, 64)],
    0x12: [("wacn", 8, 28), ("system_id", 28, 40),
           ("target_address", 40, 64)],
    0x13: [("target_address", 24, 48), ("source_address", 48, 72)],
    0x14: [("unit_status", 8, 16), ("user_status", 16, 24),
           ("target_address", 24, 48), ("source_address", 48, 72)],
    0x15: [("message", 8, 24), ("target_address", 24, 48),
           ("source_address", 48, 72)],
    0x16: [("target_address", 24, 48), ("source_address", 48, 72)],
    0x17: [("function", 8, 24), ("arguments", 24, 48),
           ("target_address", 48, 72)],
    0x20: [("request_priority_level", 20, 24),
           ("available_services", 24, 48), ("supported_services", 48, 72)],
    0x21: [("rfss_id", 8, 16), ("site_id", 16, 24),
           ("frequency_band_1", 24, 28), ("channel_number_1", 28, 40),
           ("system_service_class_1", 40, 48),
           ("frequency_band_2", 48, 52), ("channel_number_2", 52, 64),
           ("system_service_class_2", 64, 72)],
    0x22: [("location_registration_area", 8, 16), ("system_id", 20, 32),
           ("rfss_id", 32, 40), ("site_id", 40, 48),
           ("frequency_band", 48, 52), ("channel_number", 52, 64),
           ("system_service_class", 64, 72)],
    0x23: [("location_registration_area", 8, 16), ("system_id", 20, 32),
           ("rfss_id", 32, 40), ("site_id", 40, 48),
           ("frequency_band", 48, 52), ("channel_number", 52, 64),
           ("system_service_class", 64, 72)],
    0x24: [("wacn", 16, 36), ("system_id", 36, 48),
           ("frequency_band", 48, 52), ("channel_number", 52, 64),
           ("system_service_class", 64, 72)],
    0x25: [("algorithm_id", 24, 32), ("key_id", 32, 48),
           ("target_address", 48, 72)],
    0x26: [("rfss_id", 8, 16), ("site_id", 16, 24),
           ("downlink_frequency_band", 24, 28),
           ("downlink_channel_number", 28, 40),
           ("uplink_frequency_band", 40, 44),
           ("uplink_channel_number", 44, 56),
           ("system_service_class", 56, 64)],
    0x27: [("location_registration_area", 8, 16),
           ("downlink_frequency_band", 16, 20),
           ("downlink_channel_number", 20, 32), ("rfss_id", 32, 40),
           ("site_id", 40, 48), ("uplink_frequency_band", 48, 52),
           ("uplink_channel_number", 52, 64),
           ("system_service_class", 64, 72)],
    0x28: [("location_registration_area", 8, 16),
           ("uplink_frequency_band", 16, 20),
           ("uplink_channel_number", 20, 32), ("rfss_id", 32, 40),
           ("site_id", 40, 48), ("downlink_frequency_band", 48, 52),
           ("downlink_channel_number", 52, 64),
           ("system_service_class", 64, 72)],
    0x29: [("wacn", 8, 28), ("system_id", 28, 40),
           ("downlink_frequency_band", 40, 44),
           ("downlink_channel_number", 44, 56),
           ("uplink_frequency_band", 56, 60),
           ("uplink_channel_number", 60, 72)],
}

# opcodes where bits 8-16 are a vendor MFID: only parse standard vendors
_MFID_GATED = {0x00, 0x03, 0x0F}

# Motorola vendor link control (lc/motorola/*.java; opcode values from
# LinkControlOpcode.java:92-96, selected when the MFID octet is 0x90)
MFID_MOTOROLA = 0x90
_MOTO_LC_NAMES = {
    0x00: "MOTOROLA_PATCH_GROUP_VOICE_CHANNEL_USER",
    0x01: "MOTOROLA_PATCH_GROUP_VOICE_CHANNEL_UPDATE",
    0x03: "MOTOROLA_PATCH_GROUP_ADD",
    0x04: "MOTOROLA_PATCH_GROUP_DELETE",
    0x0F: "MOTOROLA_TALK_COMPLETE",
}
_MOTO_LC_FIELDS = {
    # LCMotorolaPatchGroupVoiceChannelUser.java:38-41 (patch group is
    # the call's super-talkgroup: exposed under both names so the call
    # identifier path treats it like a group address)
    0x00: [("service_options", 16, 24), ("group_address", 32, 48),
           ("patch_group", 32, 48), ("source_address", 48, 72)],
    # LCMotorolaPatchGroupVoiceChannelUpdate.java:42-47
    0x01: [("patch_group", 24, 40), ("frequency_band", 56, 60),
           ("channel_number", 60, 72)],
    # LCMotorolaPatchGroupAdd.java:37-39
    0x03: [("patch_group", 16, 32), ("patched_group_1", 32, 48),
           ("patched_group_2", 48, 64)],
    # LCMotorolaPatchGroupDelete.java:37-39
    0x04: [("patch_group", 16, 32), ("patched_group_1", 32, 48),
           ("patched_group_2", 48, 64)],
    # LCMotorolaTalkComplete.java:40
    0x0F: [("address", 48, 72)],
}


@dataclass
class LinkControl:
    protected: bool
    implicit: bool
    opcode: int
    raw: np.ndarray              # full 72 bits
    fields: dict = field(default_factory=dict)
    mfid: int = 0                # vendor (0x90 = Motorola LC words)

    @property
    def opcode_name(self) -> str:
        if self.mfid == MFID_MOTOROLA:
            return _MOTO_LC_NAMES.get(self.opcode,
                                      f"MOTOROLA_LCO_{self.opcode:02X}")
        return LCO_NAMES.get(self.opcode, f"LCO_{self.opcode:02X}")


def lc_parse(bits72: np.ndarray) -> LinkControl:
    b = np.asarray(bits72, np.uint8)
    if len(b) != 72:
        raise ValueError("link control word must be 72 bits")
    lc = LinkControl(protected=bool(b[0]), implicit=not bool(b[1]),
                     opcode=to_int(b, 2, 8), raw=b)
    mfid = to_int(b, 8, 16)
    if mfid == MFID_MOTOROLA and lc.opcode in _MOTO_LC_FIELDS:
        lc.mfid = mfid
        lc.fields = {name: to_int(b, lo, hi)
                     for name, lo, hi in _MOTO_LC_FIELDS[lc.opcode]}
        return lc
    if lc.opcode in _MFID_GATED and mfid not in (0x00, 0x01):
        return lc
    # IDEN_UP carries scaled values (LCFrequencyBandUpdate[Explicit].java)
    if lc.opcode == 0x18:
        lc.fields = {
            "identifier": to_int(b, 8, 12),
            "bandwidth_khz": to_int(b, 12, 21) * 0.125,
            "transmit_offset_mhz": to_int(b, 22, 30) * 0.25,
            "channel_spacing_khz": to_int(b, 30, 40) * 0.125,
            "base_frequency_mhz": to_int(b, 40, 72) * 5e-6,
        }
        return lc
    if lc.opcode == 0x19:
        lc.fields = {
            "identifier": to_int(b, 8, 12),
            "bandwidth_vu": to_int(b, 12, 16),
            "transmit_offset_sign": to_int(b, 16, 17),
            "transmit_offset": to_int(b, 17, 30),
            "channel_spacing_khz": to_int(b, 30, 40) * 0.125,
            "base_frequency_mhz": to_int(b, 40, 72) * 5e-6,
        }
        return lc
    layout = _LC_FIELDS.get(lc.opcode)
    if layout is not None:
        lc.fields = {name: to_int(b, lo, hi) for name, lo, hi in layout}
    return lc


def lc_build_group_voice(group: int, source: int,
                         service_options: int = 0) -> np.ndarray:
    """72-bit GROUP_VOICE_CHANNEL_USER link control word."""
    return np.concatenate([
        from_int(0, 2),                 # PF=0, SF=0 (implicit MFID)
        from_int(0x00, 6),              # LCO
        from_int(0x00, 8),              # MFID
        from_int(service_options, 8),
        from_int(0, 8),                 # reserved
        from_int(group, 16),
        from_int(source, 24),
    ])
