"""Per-protocol decoder chains: P25 Phase 1 (C4FM, LSM), P25 Phase 2,
DMR, NBFM, AM, the analog-trunking live decoders (LTR family, MPT1327)
and the auxiliary data decoders. The package exports what the reference's
does."""
from .nbfm import NBFMDecoder, NBFMConfig  # noqa: F401
from .am import AMDecoder, AMConfig  # noqa: F401
