"""Traffic mixes (JSON) and the generator that reads them."""
