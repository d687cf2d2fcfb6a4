"""Live runtime of the port (bank-mode orchestrator)."""
