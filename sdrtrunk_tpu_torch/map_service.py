"""Map service: plottable decode events -> per-entity tracks -> GeoJSON.

Role of map/MapService.java (collects PlottableDecodeEvents and pushes
updates to registered listeners) and the track-keeping of
PlottableEntityPainter/model — re-surfaced headless: tracks are kept per
entity (the FROM radio when present, else the talkgroup), bounded to
`track_length` points, and the whole picture exports as a GeoJSON
FeatureCollection (a Point feature at each entity's latest fix plus a
LineString history) that any map frontend can render.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field

from .runtime.events import DecodeEvent
from .runtime.identifiers import IdentifierForm, IdentifierRole

__all__ = ["MapService", "EntityTrack"]


@dataclass
class EntityTrack:
    entity: str
    protocol: str = ""
    points: deque = field(default_factory=lambda: deque(maxlen=50))
    last_time: float = 0.0
    heading: float | None = None
    speed: float | None = None

    @property
    def location(self) -> tuple | None:
        return self.points[-1] if self.points else None


class MapService:
    """Collects plottable events; notifies listeners; exports GeoJSON."""

    def __init__(self, track_length: int = 50):
        self.track_length = track_length
        self.tracks: dict[str, EntityTrack] = {}
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    @staticmethod
    def _entity_key(event: DecodeEvent) -> str:
        for ident in event.identifiers.all():
            if ident.role == IdentifierRole.FROM:
                return f"{ident.form.name}:{ident.value}"
        for ident in event.identifiers.all():
            if ident.form == IdentifierForm.TALKGROUP:
                return f"TALKGROUP:{ident.value}"
        return "UNKNOWN"

    def receive(self, event: DecodeEvent) -> None:
        """MapService.receive(IDecodeEvent): only plottable events with a
        valid location update the picture."""
        if not event.plottable:
            return
        lat, lon = event.location
        if lat is None or lon is None:
            return
        key = self._entity_key(event)
        track = self.tracks.get(key)
        if track is None:
            track = EntityTrack(entity=key, protocol=event.protocol,
                                points=deque(maxlen=self.track_length))
            self.tracks[key] = track
        track.points.append((float(lat), float(lon)))
        track.last_time = event.time_start
        track.heading = event.heading
        track.speed = event.speed
        for fn in self._listeners:
            fn(track)

    def to_geojson(self) -> dict:
        features = []
        for track in self.tracks.values():
            lat, lon = track.location
            props = {"entity": track.entity, "protocol": track.protocol,
                     "time": track.last_time}
            if track.heading is not None:
                props["heading"] = track.heading
            if track.speed is not None:
                props["speed"] = track.speed
            features.append({
                "type": "Feature",
                "geometry": {"type": "Point",
                             "coordinates": [lon, lat]},
                "properties": props,
            })
            if len(track.points) > 1:
                features.append({
                    "type": "Feature",
                    "geometry": {
                        "type": "LineString",
                        "coordinates": [[p[1], p[0]]
                                        for p in track.points],
                    },
                    "properties": {"entity": track.entity,
                                   "track": True},
                })
        return {"type": "FeatureCollection", "features": features}

    def write_geojson(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_geojson(), f)
