"""P25 trunking signaling block (TSBK) codec + full opcode parsing.

Wire format (TIA-102.BAAB; reference TSBKMessage/TSBKMessageFactory):
196 payload bits = interleave(trellis_1/2(96 bits)), where the 96 bits are
LB(1) P(1) OPCODE(6) MFID(8) ARGS(64) CRC-CCITT(16, complemented).

Opcode names/field layouts mirror the reference's standard message set
(module/decode/p25/phase1/message/tsbk/Opcode.java and
tsbk/standard/{osp,isp}/*.java); bit offsets below are args-relative
(absolute offset minus the 16-bit header).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bits import from_int, to_int
from ..edac.crc import check_crc16_ccitt, crc16_ccitt
from ..edac.trellis import TRELLIS_1_2_P25, deinterleave_p25, interleave_p25

__all__ = ["TSBK", "tsbk_encode", "tsbk_decode", "OSP_OPCODES",
           "ISP_OPCODES", "decode_service_options"]

# outbound (OSP) opcodes — tsbk/Opcode.java:30-94
OSP_OPCODES = {
    0x00: "GRP_V_CH_GRANT",
    0x02: "GRP_V_CH_GRANT_UPDT",
    0x03: "GRP_V_CH_GRANT_UPDT_EXP",
    0x04: "UU_V_CH_GRANT",
    0x05: "UU_ANS_REQ",
    0x06: "UU_V_CH_GRANT_UPDT",
    0x08: "TEL_INT_V_CH_GRANT",
    0x09: "TEL_INT_V_CH_GRANT_UPDT",
    0x0A: "TEL_INT_ANS_REQ",
    0x10: "IND_DATA_CH_GRANT",
    0x11: "GRP_DATA_CH_GRANT",
    0x12: "GRP_DATA_CH_ANN",
    0x13: "GRP_DATA_CH_ANN_EXP",
    0x14: "SNDCP_DATA_CH_GNT",
    0x15: "SNDCP_DATA_PAGE_REQ",
    0x16: "SNDCP_DATA_CH_ANN_EXP",
    0x18: "STS_UPDT",
    0x1A: "STS_Q",
    0x1C: "MSG_UPDT",
    0x1D: "RAD_MON_CMD",
    0x1F: "CALL_ALRT",
    0x20: "ACK_RSP_FNE",
    0x21: "QUE_RSP",
    0x24: "EXT_FNCT_CMD",
    0x27: "DENY_RSP",
    0x28: "GRP_AFF_RSP",
    0x29: "SCCB_EXP",
    0x2A: "GRP_AFF_Q",
    0x2B: "LOC_REG_RSP",
    0x2C: "U_REG_RSP",
    0x2D: "U_REG_CMD",
    0x2E: "AUTH_CMD",
    0x2F: "U_DE_REG_ACK",
    0x30: "SYNC_BCST",
    0x31: "AUTH_DEMAND",
    0x32: "AUTH_FNE_RESP",
    0x33: "IDEN_UP_TDMA",
    0x34: "IDEN_UP_VU",
    0x35: "TIME_DATE_ANN",
    0x36: "ROAM_ADDR_CMD",
    0x37: "ROAM_ADDR_UPDATE",
    0x38: "SYS_SRV_BCST",
    0x39: "SCCB",
    0x3A: "RFSS_STS_BCST",
    0x3B: "NET_STS_BCST",
    0x3C: "ADJ_STS_BCST",
    0x3D: "IDEN_UP",
    0x3E: "P_PARM_BCST",
    0x3F: "P_PARM_UPDT",
}

# inbound (ISP) opcodes — tsbk/Opcode.java:97-161
ISP_OPCODES = {
    0x00: "GRP_V_REQ",
    0x04: "UU_V_REQ",
    0x05: "UU_ANS_RSP",
    0x08: "TEL_INT_DIAL_REQ",
    0x09: "TEL_INT_PSTN_REQ",
    0x0A: "TEL_INT_ANS_RSP",
    0x10: "IND_DATA_REQ",
    0x11: "GRP_DATA_REQ",
    0x12: "SNDCP_DATA_CH_REQ",
    0x13: "SNDCP_DATA_PAGE_RES",
    0x14: "SNDCP_REC_REQ",
    0x18: "STS_UPDT_REQ",
    0x19: "STS_Q_RSP",
    0x1A: "STS_Q_REQ",
    0x1C: "MSG_UPDT_REQ",
    0x1D: "RAD_MON_REQ",
    0x1F: "CALL_ALRT_REQ",
    0x20: "ACK_RSP_U",
    0x23: "CAN_SRV_REQ",
    0x24: "EXT_FNCT_RSP",
    0x27: "EMRG_ALRM_REQ",
    0x28: "GRP_AFF_REQ",
    0x29: "GRP_AFF_Q_RSP",
    0x2B: "U_DE_REG_REQ",
    0x2C: "U_REG_REQ",
    0x2D: "LOC_REG_REQ",
    0x30: "P_PARM_REQ",
    0x32: "IDEN_UP_REQ",
    0x36: "ROAM_ADDR_REQ",
    0x37: "ROAM_ADDR_RSP",
    0x38: "AUTH_RESP",
    0x39: "AUTH_RESP_M",
    0x3A: "AUTH_FNE_RST",
    0x3B: "AUTH_SU_DMD",
}


def decode_service_options(v: int) -> dict:
    """Voice service options bitfield (reference ServiceOptions)."""
    return {
        "emergency": bool(v & 0x80),
        "encrypted": bool(v & 0x40),
        "duplex": bool(v & 0x20),
        "packet_mode": bool(v & 0x10),
        "priority": v & 0x07,
    }


@dataclass
class TSBK:
    last_block: bool
    protected: bool
    opcode: int
    mfid: int
    args: np.ndarray            # 64 bits
    corrected: int = 0
    direction: str = "outbound"
    fields: dict = field(default_factory=dict)

    @property
    def opcode_name(self) -> str:
        if self.mfid not in (0x00, 0x01):
            from .tsbk_vendor import vendor_opcode_name
            name = vendor_opcode_name(self.mfid, self.opcode)
            if name is not None:
                return name
            return f"MFID_{self.mfid:02X}_OPCODE_{self.opcode:02X}"
        table = OSP_OPCODES if self.direction == "outbound" else ISP_OPCODES
        return table.get(self.opcode, f"OPCODE_{self.opcode:02X}")

    @property
    def known(self) -> bool:
        """Whether the opcode resolved to a named structure — unknown
        rates feed the coverage counter (VERDICT r4 item 10)."""
        if self.mfid not in (0x00, 0x01):
            from .tsbk_vendor import vendor_opcode_name
            return vendor_opcode_name(self.mfid, self.opcode) is not None
        table = OSP_OPCODES if self.direction == "outbound" else ISP_OPCODES
        return self.opcode in table


def tsbk_encode(opcode: int, args: np.ndarray, mfid: int = 0,
                last_block: bool = True, protected: bool = False
                ) -> np.ndarray:
    """-> 196 on-air payload bits."""
    args = np.asarray(args, np.uint8)
    if len(args) != 64:
        raise ValueError("TSBK args must be 64 bits")
    body = np.concatenate([
        np.array([int(last_block), int(protected)], np.uint8),
        from_int(opcode, 6), from_int(mfid, 8), args])
    crc = crc16_ccitt(body)  # complemented per TIA-102.BAAB
    block96 = np.concatenate([body, from_int(crc, 16)])
    return interleave_p25(TRELLIS_1_2_P25.encode(block96))


def tsbk_decode(payload196: np.ndarray, direction: str = "outbound"
                ) -> TSBK | None:
    deint = deinterleave_p25(np.asarray(payload196, np.uint8))
    block96, errors = TRELLIS_1_2_P25.decode(deint)
    if not check_crc16_ccitt(block96, 80):
        return None
    tsbk = TSBK(
        last_block=bool(block96[0]),
        protected=bool(block96[1]),
        opcode=to_int(block96, 2, 8),
        mfid=to_int(block96, 8, 16),
        args=block96[16:80],
        corrected=errors,
        direction=direction,
    )
    tsbk.fields = _parse_args(tsbk)
    return tsbk


# --- declarative field layouts, args-relative bit [lo, hi) ---------------
# Channel grant shapes shared by several opcodes:
_GRANT = [("service_options", 0, 8), ("frequency_band", 8, 12),
          ("channel_number", 12, 24), ("group_address", 24, 40),
          ("source_address", 40, 64)]
_GRANT_UPDT = [("frequency_band_1", 0, 4), ("channel_number_1", 4, 16),
               ("group_address_1", 16, 32), ("frequency_band_2", 32, 36),
               ("channel_number_2", 36, 48), ("group_address_2", 48, 64)]
_GRANT_EXP = [("service_options", 0, 8),
              ("downlink_frequency_band", 16, 20),
              ("downlink_channel_number", 20, 32),
              ("uplink_frequency_band", 32, 36),
              ("uplink_channel_number", 36, 48), ("group_address", 48, 64)]
_UU_GRANT = [("frequency_band", 0, 4), ("channel_number", 4, 16),
             ("target_address", 16, 40), ("source_address", 40, 64)]
_TGT_SRC = [("target_address", 16, 40), ("source_address", 40, 64)]
_STATUS_LIKE = [("location_registration_area", 0, 8),
                ("system_id", 12, 24), ("rfss_id", 24, 32),
                ("site_id", 32, 40), ("frequency_band", 40, 44),
                ("channel_number", 44, 56), ("system_service_class", 56, 64)]
_WACN_SYS_TGT = [("wacn", 8, 28), ("system_id", 28, 40),
                 ("target_id", 40, 64)]

_OSP_FIELDS: dict[int, list] = {
    0x00: _GRANT,
    0x02: _GRANT_UPDT,
    0x03: _GRANT_EXP,
    0x04: _UU_GRANT,
    0x05: [("service_options", 0, 8)] + _TGT_SRC,
    0x06: _UU_GRANT,
    0x08: [("service_options", 0, 8), ("frequency_band", 8, 12),
           ("channel_number", 12, 24), ("call_timer", 24, 40),
           ("source_address", 40, 64)],
    0x09: [("service_options", 0, 8), ("frequency_band", 8, 12),
           ("channel_number", 12, 24), ("call_timer", 24, 40),
           ("any_address", 40, 64)],
    0x0A: [(f"digit_{i + 1}", 4 * i, 4 * i + 4) for i in range(10)]
          + [("target_address", 40, 64)],
    0x10: _UU_GRANT,
    0x11: _GRANT,
    0x12: _GRANT_UPDT,
    0x13: _GRANT_EXP,
    0x14: [("data_service_options", 0, 8),
           ("downlink_frequency_band", 8, 12),
           ("downlink_channel_number", 12, 24),
           ("uplink_frequency_band", 24, 28),
           ("uplink_channel_number", 28, 40), ("target_address", 40, 64)],
    0x15: [("data_service_options", 0, 8)] + _TGT_SRC,
    0x16: [("data_service_options", 0, 8),
           ("downlink_frequency_band", 16, 20),
           ("downlink_channel_number", 20, 32),
           ("uplink_frequency_band", 32, 36),
           ("uplink_channel_number", 36, 48),
           ("data_access_control", 48, 64)],
    0x18: [("unit_status", 0, 8), ("user_status", 8, 16)] + _TGT_SRC,
    0x1A: _TGT_SRC,
    0x1C: [("message", 0, 16)] + _TGT_SRC,
    0x1D: [("tx_multiplier", 14, 16), ("source_address", 16, 40),
           ("target_address", 40, 64)],
    0x1F: _TGT_SRC,
    0x20: [("additional_info_valid", 0, 1), ("extended", 1, 2),
           ("service_type", 2, 8), ("target_address", 40, 64)],
    0x21: [("additional_info_valid", 0, 1), ("service_type", 2, 8),
           ("reason", 8, 16), ("additional_info", 16, 40),
           ("target_address", 40, 64)],
    0x24: [("function", 0, 16), ("arguments", 16, 40),
           ("target_address", 40, 64)],
    0x27: [("additional_info_valid", 0, 1), ("service_type", 2, 8),
           ("reason", 8, 16), ("additional_info", 16, 40),
           ("target_address", 40, 64)],
    0x28: [("local_global", 0, 1), ("response", 6, 8),
           ("announcement_group", 8, 24), ("group_address", 24, 40),
           ("target_address", 40, 64)],
    0x29: [("rfss_id", 0, 8), ("site_id", 8, 16),
           ("transmit_frequency_band", 16, 20),
           ("transmit_channel_number", 20, 32),
           ("receive_frequency_band", 40, 44),
           ("receive_channel_number", 44, 56),
           ("system_service_class", 56, 64)],
    0x2A: _TGT_SRC,
    0x2B: [("response", 6, 8), ("group_address", 8, 24),
           ("rfss_id", 24, 32), ("site_id", 32, 40),
           ("target_address", 40, 64)],
    0x2C: [("response", 2, 4), ("system_id", 4, 16),
           ("target_unique_id", 16, 40), ("target_address", 40, 64)],
    0x2D: _TGT_SRC,
    0x2E: _WACN_SYS_TGT,
    0x2F: _WACN_SYS_TGT,
    0x30: [("leap_second_correction", 15, 17),
           ("local_time_offset_hours", 19, 23), ("year", 24, 31),
           ("month", 31, 35), ("day", 35, 40), ("hours", 40, 45),
           ("minutes", 45, 51), ("micro_slots", 51, 64)],
    0x33: [("identifier", 0, 4), ("channel_type", 4, 8),
           ("transmit_offset_sign", 8, 9), ("transmit_offset", 9, 22)],
    0x36: [("stack_operation", 0, 8)] + _WACN_SYS_TGT,
    0x38: [("available_services", 8, 32), ("supported_services", 32, 56),
           ("request_priority_level", 56, 64)],
    0x39: [("rfss_id", 0, 8), ("site_id", 8, 16),
           ("frequency_band_1", 16, 20), ("channel_number_1", 20, 32),
           ("system_service_class_1", 32, 40),
           ("frequency_band_2", 40, 44), ("channel_number_2", 44, 56),
           ("system_service_class_2", 56, 64)],
    0x3A: _STATUS_LIKE,
    0x3B: [("location_registration_area", 0, 8), ("wacn", 8, 28),
           ("system_id", 28, 40), ("frequency_band", 40, 44),
           ("channel_number", 44, 56), ("system_service_class", 56, 64)],
    0x3C: _STATUS_LIKE,
    0x3F: [("algorithm_id", 16, 24), ("key_id", 24, 40),
           ("target_address", 40, 64)],
}

_ISP_FIELDS: dict[int, list] = {
    0x00: [("service_options", 0, 8), ("group_address", 24, 40),
           ("source_address", 40, 64)],
    0x04: [("service_options", 0, 8), ("target_id", 16, 40),
           ("source_address", 40, 64)],
    0x05: [("service_options", 0, 8), ("answer_response", 8, 16)]
          + _TGT_SRC,
    0x09: [("service_options", 0, 8), ("pstn_address", 32, 40),
           ("source_address", 40, 64)],
    0x0A: [("service_options", 0, 8), ("answer_response", 8, 16),
           ("source_address", 40, 64)],
    0x10: [("service_options", 0, 8)] + _TGT_SRC,
    0x11: [("service_options", 0, 8), ("group_address", 24, 40),
           ("source_address", 40, 64)],
    0x12: [("data_service_options", 0, 8),
           ("data_access_control", 8, 24), ("source_address", 40, 64)],
    0x13: [("data_service_options", 0, 8), ("answer_response", 8, 16),
           ("data_access_control", 16, 32), ("source_address", 40, 64)],
    0x14: [("data_service_options", 0, 8),
           ("data_access_control", 8, 24), ("source_address", 40, 64)],
    0x18: [("unit_status", 0, 8), ("user_status", 8, 16)] + _TGT_SRC,
    0x19: [("unit_status", 0, 8), ("user_status", 8, 16)] + _TGT_SRC,
    0x1A: _TGT_SRC,
    0x1C: [("message", 0, 16)] + _TGT_SRC,
    0x1D: [("tx_multiplier", 14, 16)] + _TGT_SRC,
    0x1F: _TGT_SRC,
    0x20: [("service_type", 2, 8)] + _TGT_SRC,
    0x23: [("service_type", 2, 8), ("reason", 8, 16),
           ("additional_info", 16, 40), ("source_address", 40, 64)],
    0x24: [("function", 0, 16), ("arguments", 16, 40),
           ("source_address", 40, 64)],
    0x27: [("group_address", 24, 40), ("source_address", 40, 64)],
    0x28: [("system_id", 12, 24), ("group_address", 24, 40),
           ("source_address", 40, 64)],
    0x29: [("announcement_group", 8, 24), ("group_address", 24, 40),
           ("source_address", 40, 64)],
    0x2B: [("wacn", 8, 28), ("system_id", 28, 40),
           ("source_id", 40, 64)],
    0x2C: [("capability", 1, 8), ("wacn", 8, 28), ("system_id", 28, 40),
           ("source_id", 40, 64)],
    0x2D: [("capability", 1, 8), ("location_registration_area", 16, 24),
           ("group_address", 24, 40), ("source_address", 40, 64)],
    0x30: [("wacn", 8, 28), ("system_id", 28, 40),
           ("source_id", 40, 64)],
    0x32: [("frequency_band", 4, 8), ("source_address", 40, 64)],
    0x36: _TGT_SRC,
    0x37: [("message_sequence_number", 4, 8), ("wacn", 8, 28),
           ("system_id", 28, 40), ("source_id", 40, 64)],
}


def _parse_args(t: TSBK) -> dict:
    """Field extraction: standard MFIDs via the tables below, vendor
    MFIDs (Motorola 0x90 / Harris 0xA4) via tsbk_vendor."""
    a = t.args
    if t.mfid not in (0x00, 0x01):
        if t.direction == "outbound":
            from .tsbk_vendor import parse_vendor_args
            fields = parse_vendor_args(t.mfid, t.opcode, a)
            if fields is not None:
                return fields
        return {}
    if t.direction == "outbound":
        # IDEN_UP family carries scaled values (FrequencyBandUpdate*.java)
        if t.opcode == 0x3D:
            return {
                "identifier": to_int(a, 0, 4),
                "bandwidth_khz": to_int(a, 4, 13) * 0.125,
                "transmit_offset_mhz": to_int(a, 14, 22) * 0.25,
                "channel_spacing_khz": to_int(a, 22, 32) * 0.125,
                "base_frequency_mhz": to_int(a, 32, 64) * 5e-6,
            }
        if t.opcode == 0x34:
            return {
                "identifier": to_int(a, 0, 4),
                "bandwidth_vu": to_int(a, 4, 8),
                "transmit_offset_sign": to_int(a, 8, 9),
                "transmit_offset": to_int(a, 9, 22),
                "channel_spacing_khz": to_int(a, 22, 32) * 0.125,
                "base_frequency_mhz": to_int(a, 32, 64) * 5e-6,
            }
        if t.opcode == 0x33:
            f = {name: to_int(a, lo, hi)
                 for name, lo, hi in _OSP_FIELDS[0x33]}
            f["channel_spacing_khz"] = to_int(a, 22, 32) * 0.125
            f["base_frequency_mhz"] = to_int(a, 32, 64) * 5e-6
            return f
        layout = _OSP_FIELDS.get(t.opcode)
    else:
        layout = _ISP_FIELDS.get(t.opcode)
    if layout is None:
        return {}
    return {name: to_int(a, lo, hi) for name, lo, hi in layout}
