"""Alias system: map identifiers to names, colors, priorities, record and
stream flags (role of alias/AliasModel, AliasList.java and alias/id/*).

An Alias owns matchers; an AliasList resolves an Identifier to the first
matching Alias. Matchers cover the reference's main id types: talkgroup,
talkgroup range, radio id, radio id range, and NAC/site/system values.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .identifiers import Identifier, IdentifierForm

__all__ = ["Alias", "AliasList", "TalkgroupMatcher", "RadioMatcher",
           "ValueMatcher"]


@dataclass(frozen=True)
class TalkgroupMatcher:
    protocol: str
    value: int | None = None
    range_min: int | None = None
    range_max: int | None = None

    def matches(self, identifier: Identifier) -> bool:
        if identifier.form != IdentifierForm.TALKGROUP:
            return False
        if self.protocol and identifier.protocol and \
                self.protocol != identifier.protocol:
            return False
        if self.value is not None:
            return identifier.value == self.value
        return (self.range_min is not None and self.range_max is not None
                and self.range_min <= identifier.value <= self.range_max)


@dataclass(frozen=True)
class RadioMatcher:
    protocol: str
    value: int | None = None
    range_min: int | None = None
    range_max: int | None = None

    def matches(self, identifier: Identifier) -> bool:
        if identifier.form != IdentifierForm.RADIO:
            return False
        if self.protocol and identifier.protocol and \
                self.protocol != identifier.protocol:
            return False
        if self.value is not None:
            return identifier.value == self.value
        return (self.range_min is not None and self.range_max is not None
                and self.range_min <= identifier.value <= self.range_max)


@dataclass(frozen=True)
class ValueMatcher:
    form: IdentifierForm
    value: object

    def matches(self, identifier: Identifier) -> bool:
        return identifier.form == self.form and identifier.value == self.value


@dataclass
class Alias:
    name: str
    group: str = ""
    color: int = 0
    priority: int = 100          # lower = higher priority; matches reference
    record: bool = False
    stream: bool = False
    matchers: list = field(default_factory=list)

    def matches(self, identifier: Identifier) -> bool:
        return any(m.matches(identifier) for m in self.matchers)


class AliasList:
    def __init__(self, name: str = "", aliases: list[Alias] | None = None):
        self.name = name
        self.aliases: list[Alias] = list(aliases or [])

    def add(self, alias: Alias) -> None:
        self.aliases.append(alias)

    def lookup(self, identifier: Identifier) -> Alias | None:
        for alias in self.aliases:
            if alias.matches(identifier):
                return alias
        return None

    def lookup_all(self, identifiers) -> list[Alias]:
        found = []
        for ident in identifiers:
            alias = self.lookup(ident)
            if alias is not None and alias not in found:
                found.append(alias)
        return found

    def is_recordable(self, identifiers) -> bool:
        return any(a.record for a in self.lookup_all(identifiers))

    def is_streamable(self, identifiers) -> bool:
        return any(a.stream for a in self.lookup_all(identifiers))

    def priority(self, identifiers) -> int:
        found = self.lookup_all(identifiers)
        return min((a.priority for a in found), default=100)
