"""Control-channel rotation monitor (role of
source/tuner/channel/rotation/ChannelRotationMonitor.java, wired per
DecoderFactory.java:223-231): a trunked system advertises several
possible control frequencies; while the monitored channel fails to
reach an active state (CONTROL for trunking decoders) within the
rotation delay, cycle to the next candidate frequency.

Time base is the orchestrator's sample clock, so rotation is
deterministic in replay. Delay bounds mirror the reference's
200/500/2000 ms constants."""
from __future__ import annotations

from typing import Callable, Iterable

from .state import ChannelState

__all__ = ["ChannelRotationMonitor"]

ROTATION_DELAY_MINIMUM = 0.2
ROTATION_DELAY_DEFAULT = 0.5
ROTATION_DELAY_MAXIMUM = 2.0


class ChannelRotationMonitor:
    def __init__(self, frequencies: Iterable[float],
                 on_rotate: Callable[[float], None],
                 active_states: Iterable[ChannelState] = (
                     ChannelState.CONTROL,),
                 rotation_delay: float = ROTATION_DELAY_DEFAULT):
        self.frequencies = list(frequencies)
        if not self.frequencies:
            raise ValueError("need at least one candidate frequency")
        self.on_rotate = on_rotate
        self.active_states = set(active_states)
        self.rotation_delay = min(max(rotation_delay,
                                      ROTATION_DELAY_MINIMUM),
                                  ROTATION_DELAY_MAXIMUM)
        self.index = 0
        self.rotations = 0
        self._last_active = 0.0
        self._last_rotation = 0.0

    @property
    def current_frequency(self) -> float:
        return self.frequencies[self.index]

    def state(self, state: ChannelState, now: float) -> None:
        """Feed the monitored channel's current state
        (DecoderStateEvent NOTIFICATION_CHANNEL_STATE role)."""
        if state in self.active_states:
            self._last_active = now

    def check(self, now: float) -> bool:
        """Rotate if the channel has been inactive past the delay.
        Returns True when a rotation was issued."""
        if len(self.frequencies) < 2:
            return False
        anchor = max(self._last_active, self._last_rotation)
        if now - anchor < self.rotation_delay:
            return False
        self.index = (self.index + 1) % len(self.frequencies)
        self.rotations += 1
        self._last_rotation = now
        self.on_rotate(self.current_frequency)
        return True
