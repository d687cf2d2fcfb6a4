"""Alias actions: beep / clip / script triggers attached to aliases
(role of alias/action/: AliasAction.java, RecurringAction.java:35-145,
beep/BeepAction, clip/ClipAction, script/ScriptAction, dispatched by
AliasActionManager when a message's identifiers resolve to an alias that
carries actions).

Interval semantics mirror RecurringAction.Interval:
  ONCE           — fire on the first trigger only
  DELAYED_RESET  — fire, suppress re-fires for `period` seconds of the
                   sample clock, then arm again
  UNTIL_DISMISSED- fire every `period` seconds while triggers keep
                   arriving, until dismiss() is called

Time base is the orchestrator's sample clock (deterministic replay);
sinks are injected callables, so `beep` can drive a real audio output in
a desktop deployment and a collector in tests. Script actions run the
configured executable with the alias name and message summary as
arguments — the reference's ScriptAction contract.
"""
from __future__ import annotations

import enum
import subprocess
from dataclasses import dataclass, field
from typing import Callable

from .aliases import Alias, AliasList

__all__ = ["ActionInterval", "AliasAction", "BeepAction", "ClipAction",
           "ScriptAction", "AliasActionManager"]


class ActionInterval(enum.Enum):
    ONCE = "ONCE"
    DELAYED_RESET = "DELAYED_RESET"
    UNTIL_DISMISSED = "UNTIL_DISMISSED"


@dataclass
class AliasAction:
    interval: ActionInterval = ActionInterval.ONCE
    period_seconds: float = 5.0          # RecurringAction.mPeriod default
    _fired_once: bool = field(default=False, repr=False)
    _armed_at: float = field(default=-1e18, repr=False)
    _dismissed: bool = field(default=False, repr=False)

    def trigger(self, alias: Alias, summary: str, now: float) -> bool:
        """Returns True when the action actually fired."""
        if self.interval == ActionInterval.ONCE:
            if self._fired_once:
                return False
            self._fired_once = True
        elif self.interval == ActionInterval.DELAYED_RESET:
            if now - self._armed_at < self.period_seconds:
                return False
            self._armed_at = now
        else:                            # UNTIL_DISMISSED
            if self._dismissed:
                return False
            if now - self._armed_at < self.period_seconds:
                return False
            self._armed_at = now
        self.perform(alias, summary, now)
        return True

    def dismiss(self) -> None:
        self._dismissed = True

    def perform(self, alias: Alias, summary: str, now: float) -> None:
        raise NotImplementedError


@dataclass
class BeepAction(AliasAction):
    """Audible alert (beep/BeepAction.java): emits a beep request to the
    injected sink (desktop deployments bind a tone generator on the
    playback output)."""
    sink: Callable[[str], None] = print

    def perform(self, alias: Alias, summary: str, now: float) -> None:
        self.sink(f"BEEP alias={alias.name} {summary}")


@dataclass
class ClipAction(AliasAction):
    """Audio clip playback (clip/ClipAction.java): hands the configured
    clip path to the injected player."""
    path: str = ""
    player: Callable[[str], None] = lambda p: None

    def perform(self, alias: Alias, summary: str, now: float) -> None:
        self.player(self.path)


@dataclass
class ScriptAction(AliasAction):
    """External script execution (script/ScriptAction.java): runs the
    configured script with the alias name and message summary; `runner`
    is injectable for tests (defaults to a detached subprocess)."""
    script: str = ""
    runner: Callable | None = None

    def perform(self, alias: Alias, summary: str, now: float) -> None:
        argv = [self.script, alias.name, summary]
        if self.runner is not None:
            self.runner(argv)
        else:
            subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)


class AliasActionManager:
    """Routes decode events' identifiers through the alias list and
    triggers any actions on the matched aliases
    (AliasActionManager.java role). Actions are registered per alias
    name; the same action object carries its own interval state."""

    def __init__(self, alias_list: AliasList):
        self.alias_list = alias_list
        self.actions: dict[str, list[AliasAction]] = {}
        self.fired: int = 0

    def add_action(self, alias_name: str, action: AliasAction) -> None:
        self.actions.setdefault(alias_name, []).append(action)

    def receive(self, identifiers, summary: str, now: float) -> int:
        """Check identifiers against the alias list; fire matching
        actions. Returns the number of actions fired."""
        fired = 0
        for alias in self.alias_list.lookup_all(identifiers):
            for action in self.actions.get(alias.name, ()):
                if action.trigger(alias, summary, now):
                    fired += 1
        self.fired += fired
        return fired
