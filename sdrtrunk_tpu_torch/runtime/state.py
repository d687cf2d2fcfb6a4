"""Channel state machine (role of channel/state/State.java:29-78 and
StateMachine.java:39).

States and the legal-transition table mirror the reference; timeouts are
driven by explicit timestamps (seconds, typically sample_count/sample_rate)
passed by the caller, not wall-clock.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["ChannelState", "StateMachine", "SINGLE_CHANNEL_ACTIVE_STATES",
           "MULTI_CHANNEL_ACTIVE_STATES"]


class ChannelState(enum.Enum):
    ACTIVE = "ACTIVE"
    CALL = "CALL"
    CONTROL = "CONTROL"
    DATA = "DATA"
    ENCRYPTED = "ENCRYPTED"
    FADE = "FADE"
    IDLE = "IDLE"
    RESET = "RESET"
    TEARDOWN = "TEARDOWN"
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


S = ChannelState
_ALL = set(S)

# channel/state/State.java canChangeTo tables
_TRANSITIONS: dict[ChannelState, set[ChannelState]] = {
    S.ACTIVE: {S.CALL, S.CONTROL, S.DATA, S.ENCRYPTED, S.FADE, S.IDLE,
               S.TEARDOWN, S.RESET},
    S.CALL: {S.ACTIVE, S.CONTROL, S.DATA, S.ENCRYPTED, S.FADE, S.IDLE,
             S.TEARDOWN, S.RESET},
    S.CONTROL: {S.IDLE, S.FADE, S.RESET},
    S.DATA: {S.ACTIVE, S.CALL, S.CONTROL, S.ENCRYPTED, S.FADE, S.RESET,
             S.TEARDOWN},
    S.ENCRYPTED: {S.FADE, S.TEARDOWN, S.RESET},
    S.FADE: _ALL - {S.FADE, S.RESET},
    S.IDLE: _ALL - {S.TEARDOWN, S.RESET},
    S.RESET: {S.IDLE},
    S.TEARDOWN: {S.RESET},
}

SINGLE_CHANNEL_ACTIVE_STATES = {S.ACTIVE, S.CALL, S.CONTROL, S.DATA,
                                S.ENCRYPTED}
MULTI_CHANNEL_ACTIVE_STATES = SINGLE_CHANNEL_ACTIVE_STATES | {S.IDLE}


@dataclass
class StateMachine:
    """Explicit-time state machine with fade/teardown timeouts.

    fade_timeout: seconds an active state persists without refresh before
    fading; end_timeout: seconds in FADE before TEARDOWN.
    """
    timeslot: int = 0
    active_states: set = field(
        default_factory=lambda: set(SINGLE_CHANNEL_ACTIVE_STATES))
    fade_timeout: float = 1.2
    end_timeout: float = 4.0
    state: ChannelState = ChannelState.IDLE
    _fade_deadline: float = 0.0
    _end_deadline: float = 0.0
    _listeners: list = field(default_factory=list)

    def add_listener(self, fn: Callable[[ChannelState, int], None]) -> None:
        self._listeners.append(fn)

    def can_change_to(self, state: ChannelState) -> bool:
        return state in _TRANSITIONS[self.state]

    def set_state(self, state: ChannelState, now: float) -> bool:
        """Attempt a transition at time `now`; returns True if applied.
        Re-asserting an active state refreshes the fade deadline."""
        if state == self.state:
            if state in self.active_states:
                self._fade_deadline = now + self.fade_timeout
            return True
        if not self.can_change_to(state):
            return False
        self.state = state
        if state in self.active_states:
            self._fade_deadline = now + self.fade_timeout
        if state == ChannelState.FADE:
            self._end_deadline = now + self.end_timeout
        for fn in self._listeners:
            fn(state, self.timeslot)
        return True

    def check(self, now: float) -> None:
        """Apply timeout-driven transitions (StateMachine.checkState)."""
        if self.state in self.active_states and now >= self._fade_deadline:
            self.set_state(ChannelState.FADE, now)
        elif self.state == ChannelState.FADE and now >= self._end_deadline:
            self.set_state(ChannelState.TEARDOWN, now)
