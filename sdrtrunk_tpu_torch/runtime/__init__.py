"""Live runtime of the port (the orchestrator, per-slot, bank-mode and
multibank, and the bank worker process) and, as in the reference's
``runtime`` package, its host control plane: channel state machines,
decode events, identifiers, aliases and traffic-channel management."""
from .state import ChannelState, StateMachine
from .events import DecodeEvent, DecodeEventType, DecodeEventHistory
from .identifiers import (Identifier, IdentifierCollection, IdentifierRole,
                          IdentifierForm)
from .aliases import Alias, AliasList
from .traffic import TrafficChannelManager, FrequencyBand
