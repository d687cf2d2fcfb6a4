"""Live runtime of the port (the orchestrator, per-slot, bank-mode and
multibank, and the bank worker process)."""
