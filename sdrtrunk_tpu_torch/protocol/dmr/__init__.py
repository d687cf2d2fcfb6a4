"""DMR (ETSI TS 102 361) protocol layer: burst framing, CACH/SlotType/EMB,
full & embedded link control, CSBK, voice AMBE frame extraction (role of
module/decode/dmr in the reference, SURVEY.md section 2.2).
"""
from .framer import DMRFramer, DMRBurstAssembler, DMRBurstFrame
from .sync import DMRSyncPattern
