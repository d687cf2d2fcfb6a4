"""RadioReference.com service client (role of
service/radioreference/RadioReference.java:46 — in the reference a thin
wrapper over the external radio-reference-api SOAP library; here the
SOAP envelope/parse layer is in-repo with an injectable HTTP transport,
so trunked-system/site/talkgroup imports are testable offline and work
online for premium accounts).

API surface mirrors what the playlist editor imports: connection test
with account-expiry check, trunked-system detail, site list, and
talkgroup list. All calls are `doc/literal` SOAP to the v15 endpoint
with the app key + user credentials in an `authInfo` block.
"""
from __future__ import annotations

import enum
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable

__all__ = ["LoginStatus", "RadioReferenceError", "RadioReferenceClient",
           "TrunkedSystem", "Site", "Talkgroup"]

# the application key the reference ships for sdrtrunk
# (RadioReference.java:50)
SDRTRUNK_APP_KEY = "88969092"
ENDPOINT = "http://api.radioreference.com/soap2/?v=15&s=rpc"


class RadioReferenceError(RuntimeError):
    pass


class LoginStatus(enum.Enum):
    VALID_PREMIUM = "VALID_PREMIUM"
    VALID_EXPIRED = "VALID_EXPIRED"
    INVALID = "INVALID"
    ERROR = "ERROR"


@dataclass(frozen=True)
class TrunkedSystem:
    system_id: int
    name: str
    system_type: str = ""
    flavor: str = ""
    voice: str = ""


@dataclass(frozen=True)
class Site:
    site_id: int
    description: str
    frequencies: tuple = ()        # control/alternate control, Hz


@dataclass(frozen=True)
class Talkgroup:
    decimal: int
    description: str
    mode: str = ""
    category: str = ""


def _text(el, tag, default=""):
    child = el.find(f".//{tag}")
    return child.text if child is not None and child.text else default


class RadioReferenceClient:
    """transport: callable (url, body_bytes, headers) -> response bytes;
    defaults to urllib (requires network + premium credentials)."""

    def __init__(self, username: str, password: str,
                 app_key: str = SDRTRUNK_APP_KEY,
                 transport: Callable | None = None,
                 endpoint: str = ENDPOINT):
        self.username = username
        self.password = password
        self.app_key = app_key
        self.endpoint = endpoint
        self._transport = transport or self._urllib_transport

    @staticmethod
    def _urllib_transport(url: str, body: bytes, headers: dict) -> bytes:
        import urllib.request
        req = urllib.request.Request(url, data=body, headers=headers)
        with urllib.request.urlopen(req, timeout=20) as resp:
            return resp.read()

    # --- SOAP plumbing -------------------------------------------------

    def _auth_block(self) -> str:
        return (f"<authInfo><appKey>{self.app_key}</appKey>"
                f"<username>{self.username}</username>"
                f"<password>{self.password}</password>"
                f"<version>15</version></authInfo>")

    def _call(self, method: str, args_xml: str = "") -> ET.Element:
        body = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<SOAP-ENV:Envelope xmlns:SOAP-ENV='
            '"http://schemas.xmlsoap.org/soap/envelope/">'
            f"<SOAP-ENV:Body><{method}>{args_xml}{self._auth_block()}"
            f"</{method}></SOAP-ENV:Body></SOAP-ENV:Envelope>"
        ).encode()
        try:
            raw = self._transport(self.endpoint, body, {
                "Content-Type": "text/xml; charset=utf-8",
                "SOAPAction": method,
            })
        except Exception as e:
            raise RadioReferenceError(f"{method} transport failed: {e}")
        try:
            root = ET.fromstring(raw)
        except ET.ParseError as e:
            raise RadioReferenceError(f"{method} bad response: {e}")
        fault = root.find(".//faultstring")
        if fault is not None:
            raise RadioReferenceError(f"{method} fault: {fault.text}")
        return root

    # --- API surface ---------------------------------------------------

    def test_connection(self) -> LoginStatus:
        """RadioReference.testConnectionWithExp:181 equivalent: validate
        credentials via getUserData and check the account expiry."""
        try:
            root = self._call("getUserData")
        except RadioReferenceError as e:
            return (LoginStatus.INVALID if "fault" in str(e).lower()
                    else LoginStatus.ERROR)
        if _text(root, "subLevel", "0") in ("0", ""):
            return LoginStatus.VALID_EXPIRED
        return LoginStatus.VALID_PREMIUM

    def get_system(self, system_id: int) -> TrunkedSystem:
        root = self._call("getTrsDetails",
                          f"<sid>{int(system_id)}</sid>")
        return TrunkedSystem(
            system_id=int(system_id),
            name=_text(root, "sName"),
            system_type=_text(root, "sType"),
            flavor=_text(root, "sFlavor"),
            voice=_text(root, "sVoice"))

    def get_sites(self, system_id: int) -> list[Site]:
        root = self._call("getTrsSites", f"<sid>{int(system_id)}</sid>")
        sites = []
        for el in root.iter():
            if el.tag.endswith("item") and el.find(".//siteId") is not None:
                freqs = tuple(
                    float(f.text) * 1e6
                    for f in el.findall(".//siteFreq/.//freq")
                    if f.text)
                sites.append(Site(
                    site_id=int(_text(el, "siteId", "0")),
                    description=_text(el, "siteDescr"),
                    frequencies=freqs))
        return sites

    def get_talkgroups(self, system_id: int) -> list[Talkgroup]:
        root = self._call("getTrsTalkgroups",
                          f"<sid>{int(system_id)}</sid><tgCid>0</tgCid>"
                          "<tgTag>0</tgTag><tgDec>0</tgDec>")
        tgs = []
        for el in root.iter():
            if el.tag.endswith("item") and el.find(".//tgDec") is not None:
                tgs.append(Talkgroup(
                    decimal=int(_text(el, "tgDec", "0")),
                    description=_text(el, "tgDescr"),
                    mode=_text(el, "tgMode"),
                    category=_text(el, "tgCid")))
        return tgs
