"""Per-protocol decoder chains (the ported ones: P25 Phase 1 C4FM)."""
