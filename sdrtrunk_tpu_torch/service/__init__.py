"""External service clients (reference service/ package)."""
from .radioreference import (LoginStatus, RadioReferenceClient,
                             RadioReferenceError)

__all__ = ["LoginStatus", "RadioReferenceClient", "RadioReferenceError"]
