"""Typed identifiers and per-channel identifier collections (role of
identifier/Identifier.java:27, IdentifierCollection.java:37 and the
identifier/id/* class hierarchy).

An Identifier is (identifier_class, form, role, value, protocol); the
collection keeps the latest identifier per (class, form, role) slot, like
the reference's MutableIdentifierCollection update semantics.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Iterable

__all__ = ["IdentifierClass", "IdentifierForm", "IdentifierRole",
           "Identifier", "IdentifierCollection"]


class IdentifierClass(enum.Enum):
    USER = "USER"
    CONFIGURATION = "CONFIGURATION"
    DECODER = "DECODER"
    NETWORK = "NETWORK"
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


class IdentifierForm(enum.Enum):
    TALKGROUP = "TALKGROUP"
    RADIO = "RADIO"
    NAC = "NAC"
    SYSTEM = "SYSTEM"
    SITE = "SITE"
    RFSS = "RFSS"
    WACN = "WACN"
    CHANNEL = "CHANNEL"
    FREQUENCY = "FREQUENCY"
    COLOR_CODE = "COLOR_CODE"
    ENCRYPTION_KEY = "ENCRYPTION_KEY"
    STATE = "STATE"
    LOCATION = "LOCATION"
    ALIAS_LIST = "ALIAS_LIST"
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


class IdentifierRole(enum.Enum):
    FROM = "FROM"
    TO = "TO"
    ANY = "ANY"
    BROADCAST = "BROADCAST"
    # enum members are singletons and Enum equality is identity;
    # object.__hash__ is the same semantics without the Python-level
    # hash(self._name_) call (a measured cost at ~75k hashes/chunk)
    __hash__ = object.__hash__


@dataclass(frozen=True)
class Identifier:
    value: Any
    identifier_class: IdentifierClass
    form: IdentifierForm
    role: IdentifierRole = IdentifierRole.ANY
    protocol: str = ""

    # --- convenience constructors for the common kinds ---
    @staticmethod
    def talkgroup(value: int, role: IdentifierRole = IdentifierRole.TO,
                  protocol: str = "") -> "Identifier":
        return Identifier(value, IdentifierClass.USER,
                          IdentifierForm.TALKGROUP, role, protocol)

    @staticmethod
    def radio(value: int, role: IdentifierRole = IdentifierRole.FROM,
              protocol: str = "") -> "Identifier":
        return Identifier(value, IdentifierClass.USER, IdentifierForm.RADIO,
                          role, protocol)

    @staticmethod
    def nac(value: int) -> "Identifier":
        return Identifier(value, IdentifierClass.NETWORK, IdentifierForm.NAC,
                          IdentifierRole.BROADCAST, "APCO25")

    @staticmethod
    def frequency(value_hz: float) -> "Identifier":
        return Identifier(value_hz, IdentifierClass.CONFIGURATION,
                          IdentifierForm.FREQUENCY, IdentifierRole.ANY)

    @staticmethod
    def site(value: int, protocol: str = "") -> "Identifier":
        return Identifier(value, IdentifierClass.NETWORK, IdentifierForm.SITE,
                          IdentifierRole.BROADCAST, protocol)


@dataclass
class IdentifierCollection:
    """Latest-wins collection keyed by (class, form, role)."""
    identifiers: dict = field(default_factory=dict)
    timeslot: int = 0

    def update(self, identifier: Identifier) -> None:
        key = (identifier.identifier_class, identifier.form, identifier.role)
        self.identifiers[key] = identifier

    def update_all(self, identifiers: Iterable[Identifier]) -> None:
        for i in identifiers:
            self.update(i)

    def remove(self, identifier_class=None, form=None, role=None) -> None:
        def match(key):
            kc, kf, kr = key
            return ((identifier_class is None or kc == identifier_class)
                    and (form is None or kf == form)
                    and (role is None or kr == role))
        for key in [k for k in self.identifiers if match(k)]:
            del self.identifiers[key]

    def get(self, form: IdentifierForm,
            role: IdentifierRole | None = None) -> Identifier | None:
        for (kc, kf, kr), ident in self.identifiers.items():
            if kf == form and (role is None or kr == role):
                return ident
        return None

    def all(self) -> list[Identifier]:
        return list(self.identifiers.values())

    def copy(self) -> "IdentifierCollection":
        return IdentifierCollection(dict(self.identifiers), self.timeslot)
