"""P25 Phase 2 MAC message parsing (the trunking control plane of P25P2).

Mirrors the reference's MAC stack (module/decode/p25/phase2/message/mac/
MacMessage.java, MacMessageFactory.java, MacOpcode.java, structure/*):

  * a FACCH (156-bit) or SACCH (180-bit) info field is one MAC PDU:
    PDU_TYPE(3) OFFSET(3) RESERVED(2) then content
  * PTT / END_PTT PDUs are one fixed structure spanning the whole PDU
  * IDLE / ACTIVE / HANGTIME PDUs chain up to three MacStructures
    starting at bit 8; each begins with an 8-bit opcode whose table
    length (octets) locates the next structure
  * field layouts are relative to the structure start, mirroring
    mac/structure/*.java

This is what makes P25P2 *trunking* possible: grants, channel users,
PTT/END, and network status (whose WACN/SYS/NAC seed the scrambler).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bits import from_int, to_int
from .timeslot import MacPduType

__all__ = ["MacStructure", "MacPdu", "parse_mac_pdu", "build_mac_pdu",
           "MAC_OPCODE_NAMES", "MAC_OPCODE_LENGTHS", "mac_structure_encode"]

# opcode -> (name, length in octets) — mac/MacOpcode.java:36-101
# length -1 = consumes the rest of the PDU
_OPCODES: dict[int, tuple[str, int]] = {
    0: ("NULL_INFORMATION", -1),
    1: ("GROUP_VOICE_CHANNEL_USER_ABBREVIATED", 7),
    2: ("UNIT_TO_UNIT_VOICE_CHANNEL_USER", 8),
    3: ("TELEPHONE_INTERCONNECT_VOICE_CHANNEL_USER", 7),
    5: ("GROUP_VOICE_CHANNEL_GRANT_UPDATE_MULTIPLE", 16),
    17: ("INDIRECT_GROUP_PAGING", -1),
    18: ("INDIVIDUAL_PAGING_WITH_PRIORITY", -1),
    33: ("GROUP_VOICE_CHANNEL_USER_EXTENDED", 14),
    34: ("UNIT_TO_UNIT_VOICE_CHANNEL_USER_EXTENDED", 15),
    37: ("GROUP_VOICE_CHANNEL_GRANT_UPDATE_MULTIPLE_EXPLICIT", 15),
    48: ("POWER_CONTROL_SIGNAL_QUALITY", 5),
    49: ("MAC_RELEASE", 7),
    64: ("GROUP_VOICE_CHANNEL_GRANT_ABBREVIATED", 9),
    65: ("GROUP_VOICE_SERVICE_REQUEST", 7),
    66: ("GROUP_VOICE_CHANNEL_GRANT_UPDATE", 9),
    68: ("UNIT_TO_UNIT_VOICE_CHANNEL_GRANT_ABBREVIATED", 9),
    69: ("UNIT_TO_UNIT_ANSWER_REQUEST_ABBREVIATED", 8),
    70: ("UNIT_TO_UNIT_VOICE_CHANNEL_GRANT_UPDATE_ABBREVIATED", 9),
    74: ("TELEPHONE_INTERCONNECT_ANSWER_REQUEST", 9),
    76: ("RADIO_UNIT_MONITOR_COMMAND_ABBREVIATED", 10),
    84: ("SNDCP_DATA_CHANNEL_GRANT", 9),
    85: ("SNDCP_DATA_PAGE_REQUEST", 7),
    88: ("STATUS_UPDATE_ABBREVIATED", 10),
    90: ("STATUS_QUERY_ABBREVIATED", 7),
    92: ("MESSAGE_UPDATE_ABBREVIATED", 10),
    94: ("RADIO_UNIT_MONITOR_COMMAND_ENHANCED", 14),
    95: ("CALL_ALERT_ABBREVIATED", 7),
    96: ("ACK_RESPONSE", 9),
    97: ("QUEUED_RESPONSE", 9),
    100: ("EXTENDED_FUNCTION_COMMAND_ABBREVIATED", 9),
    103: ("DENY_RESPONSE", 9),
    106: ("GROUP_AFFILIATION_QUERY_ABBREVIATED", 7),
    109: ("UNIT_REGISTRATION_COMMAND_ABBREVIATED", 7),
    115: ("IDENTIFIER_UPDATE_TDMA", 9),
    116: ("IDENTIFIER_UPDATE_V_UHF", 9),
    117: ("TIME_AND_DATE_ANNOUNCEMENT", 9),
    120: ("SYSTEM_SERVICE_BROADCAST", 9),
    121: ("SECONDARY_CONTROL_CHANNEL_BROADCAST_ABBREVIATED", 9),
    122: ("RFSS_STATUS_BROADCAST_ABBREVIATED", 9),
    123: ("NETWORK_STATUS_BROADCAST_ABBREVIATED", 11),
    124: ("ADJACENT_STATUS_BROADCAST_ABBREVIATED", 9),
    125: ("IDENTIFIER_UPDATE", 9),
    192: ("GROUP_VOICE_CHANNEL_GRANT_EXTENDED", 11),
    195: ("GROUP_VOICE_CHANNEL_GRANT_UPDATE_EXPLICIT", 8),
    196: ("UNIT_TO_UNIT_VOICE_CHANNEL_GRANT_EXTENDED", 15),
    197: ("UNIT_TO_UNIT_ANSWER_REQUEST_EXTENDED", 12),
    198: ("UNIT_TO_UNIT_VOICE_CHANNEL_GRANT_UPDATE_EXTENDED", 15),
    204: ("RADIO_UNIT_MONITOR_COMMAND_EXTENDED", 14),
    214: ("SNDCP_DATA_CHANNEL_ANNOUNCEMENT_EXPLICIT", 9),
    216: ("STATUS_UPDATE_EXTENDED", 14),
    218: ("STATUS_QUERY_EXTENDED", 11),
    220: ("MESSAGE_UPDATE_EXTENDED", 14),
    223: ("CALL_ALERT_EXTENDED", 11),
    228: ("EXTENDED_FUNCTION_COMMAND_EXTENDED", 14),
    233: ("SECONDARY_CONTROL_CHANNEL_BROADCAST_EXPLICIT", 8),
    234: ("GROUP_AFFILIATION_QUERY_EXTENDED", 11),
    250: ("RFSS_STATUS_BROADCAST_EXTENDED", 11),
    251: ("NETWORK_STATUS_BROADCAST_EXTENDED", 13),
    252: ("ADJACENT_STATUS_BROADCAST_EXTENDED", 11),
}

MAC_OPCODE_NAMES = {k: v[0] for k, v in _OPCODES.items()}
MAC_OPCODE_LENGTHS = {k: v[1] for k, v in _OPCODES.items()}

# field layouts relative to structure start (mac/structure/*.java)
_GRANT_ABBR = [("service_options", 8, 16), ("frequency_band", 16, 20),
               ("channel_number", 20, 32), ("group_address", 32, 48),
               ("source_address", 48, 72)]
_STATUS_BCAST = [("location_registration_area", 8, 16),
                 ("system_id", 20, 32), ("rfss_id", 32, 40),
                 ("site_id", 40, 48), ("frequency_band", 48, 52),
                 ("channel_number", 52, 64),
                 ("system_service_class", 64, 72)]

_FIELDS: dict[int, list] = {
    1: [("service_options", 8, 16), ("group_address", 16, 32),
        ("source_address", 32, 56)],
    2: [("service_options", 8, 16), ("target_address", 16, 40),
        ("source_address", 40, 64)],
    3: [("service_options", 8, 16), ("call_timer", 16, 32),
        ("source_address", 32, 56)],
    5: [("service_options_1", 8, 16), ("frequency_band_1", 16, 20),
        ("channel_number_1", 20, 32), ("group_address_1", 32, 48),
        ("service_options_2", 48, 56), ("frequency_band_2", 56, 60),
        ("channel_number_2", 60, 72), ("group_address_2", 72, 88),
        ("service_options_3", 88, 96), ("frequency_band_3", 96, 100),
        ("channel_number_3", 100, 112), ("group_address_3", 112, 128)],
    33: [("service_options", 8, 16), ("group_address", 16, 32),
         ("source_address", 32, 56), ("source_wacn", 56, 76),
         ("source_system", 76, 88), ("source_id", 88, 112)],
    34: [("service_options", 8, 16), ("target_address", 16, 40),
         ("source_address", 40, 64), ("source_wacn", 64, 84),
         ("source_system", 84, 96), ("source_id", 96, 120)],
    37: [("service_options_1", 8, 16), ("frequency_band_1", 16, 20),
         ("channel_number_1", 20, 32),
         ("receive_frequency_band_1", 32, 36),
         ("receive_channel_number_1", 36, 48),
         ("group_address_1", 48, 64), ("service_options_2", 64, 72),
         ("frequency_band_2", 72, 76), ("channel_number_2", 76, 88),
         ("receive_frequency_band_2", 88, 92),
         ("receive_channel_number_2", 92, 104),
         ("group_address_2", 104, 120)],
    48: [("target_address", 8, 32), ("rf_level", 32, 36),
         ("bit_error_rate", 36, 40)],
    49: [("target_address", 16, 40), ("color_code", 44, 56)],
    64: _GRANT_ABBR,
    65: [("service_options", 8, 16), ("group_address", 16, 32),
         ("source_address", 32, 56)],
    66: [("frequency_band_1", 8, 12), ("channel_number_1", 12, 24),
         ("group_address_1", 24, 40), ("frequency_band_2", 40, 44),
         ("channel_number_2", 44, 56), ("group_address_2", 56, 72)],
    68: [("frequency_band", 8, 12), ("channel_number", 12, 24),
         ("target_address", 16, 40), ("source_address", 40, 64)],
    69: [("service_options", 8, 16), ("target_address", 16, 40),
         ("source_address", 40, 64)],
    70: [("frequency_band", 8, 12), ("channel_number", 12, 24),
         ("target_address", 16, 40), ("source_address", 40, 64)],
    74: [(f"digit_{i + 1}", 8 + 4 * i, 12 + 4 * i) for i in range(10)]
        + [("target_address", 48, 72)],
    76: [("transmit_time", 16, 24), ("transmit_multiplier", 30, 32),
         ("target_address", 32, 56), ("source_address", 56, 80)],
    84: [("service_options", 8, 16), ("frequency_band", 16, 20),
         ("channel_number", 20, 32), ("receive_frequency_band", 32, 36),
         ("receive_channel_number", 36, 48), ("target_address", 48, 72)],
    85: [("service_options", 8, 16), ("data_access_control", 16, 32),
         ("target_address", 32, 56)],
    88: [("unit_status", 16, 24), ("user_status", 24, 32),
         ("target_address", 32, 56), ("source_address", 56, 80)],
    90: [("target_address", 8, 32), ("source_address", 32, 56)],
    92: [("message", 16, 32), ("target_address", 32, 56),
         ("source_address", 56, 80)],
    95: [("target_address", 8, 32), ("source_address", 32, 56)],
    96: [("service_type", 10, 16), ("target_address", 48, 72)],
    97: [("service_type", 10, 16), ("reason", 24, 32),
         ("additional_info", 32, 56), ("target_address", 56, 80)],
    100: [("function", 8, 24), ("arguments", 24, 48),
          ("target_address", 48, 72)],
    103: [("service_type", 10, 16), ("reason", 24, 32),
          ("additional_info", 32, 56), ("target_address", 56, 80)],
    106: [("target_address", 8, 32), ("source_address", 32, 56)],
    109: [("target_address", 8, 32), ("source_address", 32, 56)],
    117: [("local_time_offset", 12, 24), ("date", 24, 48),
          ("time", 48, 72)],
    120: [("twuid_validity", 8, 16), ("available_services", 16, 40),
          ("supported_services", 40, 64),
          ("request_priority_level", 64, 72)],
    121: [("rfss_id", 8, 16), ("site_id", 16, 24),
          ("frequency_band_1", 24, 28), ("channel_number_1", 28, 40),
          ("system_service_class_1", 40, 48),
          ("frequency_band_2", 48, 52), ("channel_number_2", 52, 64),
          ("system_service_class_2", 64, 72)],
    122: _STATUS_BCAST,
    123: [("location_registration_area", 8, 16), ("wacn", 16, 36),
          ("system_id", 36, 48), ("frequency_band", 48, 52),
          ("channel_number", 52, 64), ("system_service_class", 64, 72),
          ("color_code", 76, 88)],
    124: _STATUS_BCAST,
    192: [("service_options", 8, 16), ("frequency_band", 16, 20),
          ("channel_number", 20, 32), ("receive_frequency_band", 32, 36),
          ("receive_channel_number", 36, 48), ("group_address", 48, 64),
          ("source_address", 64, 88)],
    195: [("service_options", 8, 16), ("frequency_band", 16, 20),
          ("channel_number", 20, 32), ("receive_frequency_band", 32, 36),
          ("receive_channel_number", 36, 48), ("group_address", 48, 64)],
    196: [("frequency_band", 8, 12), ("channel_number", 12, 24),
          ("receive_frequency_band", 24, 28),
          ("receive_channel_number", 28, 40), ("source_wacn", 40, 60),
          ("source_system", 60, 72), ("source_id", 72, 96),
          ("target_address", 96, 120)],
    204: [("transmit_time", 16, 24), ("transmit_multiplier", 30, 32),
          ("target_address", 32, 56), ("source_wacn", 56, 76),
          ("source_system", 76, 88), ("source_address", 88, 112)],
    214: [("service_options", 8, 16), ("frequency_band", 24, 28),
          ("channel_number", 28, 40), ("receive_frequency_band", 40, 44),
          ("receive_channel_number", 44, 56),
          ("data_access_control", 56, 72)],
    216: [("unit_status", 16, 24), ("user_status", 24, 32),
          ("target_address", 32, 56), ("source_wacn", 56, 76),
          ("source_system", 76, 88), ("source_address", 88, 112)],
    220: [("message", 16, 32), ("target_address", 32, 56),
          ("source_wacn", 56, 76), ("source_system", 76, 88),
          ("source_address", 88, 112)],
    223: [("target_address", 8, 32), ("source_wacn", 32, 52),
          ("source_system", 52, 64), ("source_address", 64, 88)],
    233: [("rfss_id", 8, 16), ("site_id", 16, 24),
          ("frequency_band", 24, 28), ("channel_number", 28, 40),
          ("receive_frequency_band", 40, 44),
          ("receive_channel_number", 44, 56),
          ("system_service_class", 56, 64)],
    234: [("target_address", 8, 32), ("source_wacn", 32, 52),
          ("source_system", 52, 64), ("source_address", 64, 88)],
    250: [("location_registration_area", 8, 16), ("system_id", 20, 32),
          ("rfss_id", 32, 40), ("site_id", 40, 48),
          ("frequency_band", 48, 52), ("channel_number", 52, 64),
          ("receive_frequency_band", 64, 68),
          ("receive_channel_number", 68, 80),
          ("system_service_class", 80, 88)],
    251: [("location_registration_area", 8, 16), ("wacn", 16, 36),
          ("system_id", 36, 48), ("frequency_band", 48, 52),
          ("channel_number", 52, 64), ("receive_frequency_band", 64, 68),
          ("receive_channel_number", 68, 80),
          ("system_service_class", 80, 88), ("color_code", 92, 104)],
    252: [("location_registration_area", 8, 16), ("system_id", 20, 32),
          ("rfss_id", 32, 40), ("site_id", 40, 48),
          ("frequency_band", 48, 52), ("channel_number", 52, 64),
          ("receive_frequency_band", 64, 68),
          ("receive_channel_number", 68, 80),
          ("system_service_class", 80, 88)],
}

# IDEN_UP variants carry scaled values (FrequencyBandUpdate*.java)
_IDEN_OPCODES = {115, 116, 125}


@dataclass
class MacStructure:
    opcode: int
    fields: dict = field(default_factory=dict)
    bits: np.ndarray | None = None

    @property
    def opcode_name(self) -> str:
        return MAC_OPCODE_NAMES.get(self.opcode,
                                    f"MAC_OPCODE_{self.opcode}")

    @property
    def known(self) -> bool:
        """Opcode resolved to a named structure (coverage counter)."""
        return self.opcode in MAC_OPCODE_NAMES


@dataclass
class MacPdu:
    pdu_type: MacPduType
    offset_to_next_voice: int
    structures: list


def _parse_structure(bits: np.ndarray) -> MacStructure:
    opcode = to_int(bits, 0, 8)
    s = MacStructure(opcode=opcode, bits=bits)
    if opcode in _IDEN_OPCODES:
        if opcode == 125:
            s.fields = {
                "identifier": to_int(bits, 8, 12),
                "bandwidth_khz": to_int(bits, 12, 21) * 0.125,
                "transmit_offset_mhz": to_int(bits, 22, 30) * 0.25,
                "channel_spacing_khz": to_int(bits, 30, 40) * 0.125,
                "base_frequency_mhz": to_int(bits, 40, 72) * 5e-6,
            }
        elif opcode == 115:
            s.fields = {
                "identifier": to_int(bits, 8, 12),
                "channel_type": to_int(bits, 12, 16),
                "transmit_offset_sign": to_int(bits, 16, 17),
                "transmit_offset": to_int(bits, 17, 30),
                "channel_spacing_khz": to_int(bits, 30, 40) * 0.125,
                "base_frequency_mhz": to_int(bits, 40, 72) * 5e-6,
            }
        else:  # 116 V/UHF
            s.fields = {
                "identifier": to_int(bits, 8, 12),
                "bandwidth_vu": to_int(bits, 12, 21),
                "transmit_offset_sign": to_int(bits, 21, 22),
                "transmit_offset": to_int(bits, 22, 30),
                "channel_spacing_khz": to_int(bits, 30, 40) * 0.125,
                "base_frequency_mhz": to_int(bits, 40, 72) * 5e-6,
            }
        return s
    layout = _FIELDS.get(opcode)
    if layout is not None:
        n = len(bits)
        s.fields = {name: to_int(bits, lo, hi)
                    for name, lo, hi in layout if hi <= n}
    return s


def parse_mac_pdu(info_bits: np.ndarray) -> MacPdu:
    """Parse a FACCH/SACCH info field into MAC structures
    (MacMessageFactory.create / getMacStructureIndices)."""
    b = np.asarray(info_bits, np.uint8)
    pdu_type = MacPduType(to_int(b, 0, 3))
    offset = to_int(b, 3, 6)
    structures: list[MacStructure] = []
    if pdu_type in (MacPduType.PTT, MacPduType.END_PTT):
        s = MacStructure(opcode=-1, bits=b)
        if pdu_type == MacPduType.PTT:
            s.fields = {            # structure/PushToTalk.java
                "message_indicator": to_int(b, 8, 44) << 36
                                     | to_int(b, 44, 80),
                "algorithm_id": to_int(b, 80, 88),
                "key_id": to_int(b, 88, 104),
                "source_address": to_int(b, 104, 128),
                "group_address": to_int(b, 128, 144),
            }
        else:                       # structure/EndPushToTalk.java
            s.fields = {
                "color_code": to_int(b, 12, 24),
                "source_address": to_int(b, 104, 128),
                "group_address": to_int(b, 128, 144),
            }
        structures.append(s)
        return MacPdu(pdu_type, offset, structures)
    if pdu_type not in (MacPduType.IDLE, MacPduType.ACTIVE,
                        MacPduType.HANGTIME):
        return MacPdu(pdu_type, offset, structures)
    # chained structures starting at bit 8, up to three
    idx = 8
    for _ in range(3):
        if idx + 8 > len(b):
            break
        opcode = to_int(b, idx, idx + 8)
        if opcode == 0 and structures:   # NULL terminates the chain
            break
        length = MAC_OPCODE_LENGTHS.get(opcode, -1)
        end = idx + length * 8 if length > 0 else len(b)
        structures.append(_parse_structure(b[idx:min(end, len(b))]))
        if length <= 0 or end >= len(b):
            break
        idx = end
    return MacPdu(pdu_type, offset, structures)


def mac_structure_encode(opcode: int, fields: dict) -> np.ndarray:
    """Build one MAC structure's bits from a field dict (tests only)."""
    length = MAC_OPCODE_LENGTHS.get(opcode)
    if length is None or length <= 0:
        raise ValueError(f"cannot encode variable-length opcode {opcode}")
    bits = np.zeros(length * 8, np.uint8)
    bits[0:8] = from_int(opcode, 8)
    layout = _FIELDS.get(opcode, [])
    for name, lo, hi in layout:
        if name in fields:
            bits[lo:hi] = from_int(int(fields[name]), hi - lo)
    return bits


def build_mac_pdu(pdu_type: MacPduType, structures: list[np.ndarray],
                  total_bits: int, offset: int = 0) -> np.ndarray:
    """Assemble a FACCH/SACCH info field from encoded structures
    (tests only; pads with NULL_INFORMATION)."""
    b = np.zeros(total_bits, np.uint8)
    b[0:3] = from_int(pdu_type.value, 3)
    b[3:6] = from_int(offset, 3)
    idx = 8
    for s in structures:
        if idx + len(s) > total_bits:
            raise ValueError("structures exceed PDU capacity")
        b[idx:idx + len(s)] = s
        idx += len(s)
    return b
