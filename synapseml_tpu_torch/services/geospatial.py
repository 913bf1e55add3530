"""Azure Maps geospatial transformers.

Reference: cognitive/.../services/geospatial/ (~667 LoC: Geocoders.scala
AddressGeocoder/ReverseAddressGeocoder batch jobs, CheckPointInPolygon.scala,
AzureMapsTraits). Azure Maps uses ``subscription-key`` as a query parameter
rather than a header.

The port's copy of the JAX package's ``services/geospatial.py`` (host code;
the port imports nothing of that package).
"""

from __future__ import annotations


from ..core.params import Param
from .base import CognitiveServiceBase

_ATLAS = "https://atlas.microsoft.com"


class _AzureMapsBase(CognitiveServiceBase):
    apiVersion = Param("apiVersion", "API version", str, "1.0")

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.isSet("url"):
            self.set("url", _ATLAS)

    def _key_query(self, df, i) -> str:
        key = self._resolve("subscriptionKey", df, i)
        return f"&subscription-key={key}" if key else ""


def _coords_present(df, stage, i) -> bool:
    """Null lat/lon rows are skipped (null output), matching the base
    protocol's _prepare_body-returns-None convention."""
    import numpy as np

    lat = df[stage.getLatitudeCol()][i]
    lon = df[stage.getLongitudeCol()][i]
    def ok(v):
        return v is not None and not (isinstance(v, float) and np.isnan(v))
    return ok(lat) and ok(lon)


class AddressGeocoder(_AzureMapsBase):
    """Address → coordinates (reference Geocoders.scala AddressGeocoder)."""

    addressCol = Param("addressCol", "column of address strings", str,
                       "address")

    def _prepare_method(self):
        return "GET"

    def _prepare_url(self, df, i):
        from urllib.parse import quote

        q = quote(str(df[self.getAddressCol()][i]))
        return (f"{self.get('url').rstrip('/')}/search/address/json"
                f"?api-version={self.getApiVersion()}&query={q}"
                + self._key_query(df, i))

    def _prepare_body(self, df, i):
        return b"" if df[self.getAddressCol()][i] is not None else None

    def _parse_response(self, parsed, df, i):
        try:
            return parsed["results"]
        except (KeyError, TypeError):
            return parsed


class ReverseAddressGeocoder(_AzureMapsBase):
    """(lat, lon) → address (reference ReverseAddressGeocoder)."""

    latitudeCol = Param("latitudeCol", "latitude column", str, "lat")
    longitudeCol = Param("longitudeCol", "longitude column", str, "lon")

    def _prepare_method(self):
        return "GET"

    def _prepare_url(self, df, i):
        lat = float(df[self.getLatitudeCol()][i])
        lon = float(df[self.getLongitudeCol()][i])
        return (f"{self.get('url').rstrip('/')}/search/address/reverse/json"
                f"?api-version={self.getApiVersion()}&query={lat},{lon}"
                + self._key_query(df, i))

    def _prepare_body(self, df, i):
        return b"" if _coords_present(df, self, i) else None

    def _parse_response(self, parsed, df, i):
        try:
            return parsed["addresses"]
        except (KeyError, TypeError):
            return parsed


class CheckPointInPolygon(_AzureMapsBase):
    """Point-in-polygon check against an uploaded geofence
    (reference CheckPointInPolygon.scala)."""

    latitudeCol = Param("latitudeCol", "latitude column", str, "lat")
    longitudeCol = Param("longitudeCol", "longitude column", str, "lon")
    userDataIdentifier = Param("userDataIdentifier",
                               "udid of the uploaded polygon set", str)

    def _prepare_method(self):
        return "GET"

    def _prepare_url(self, df, i):
        udid = self._resolve("userDataIdentifier", df, i)
        if not udid:
            raise ValueError("CheckPointInPolygon: userDataIdentifier not set")
        lat = float(df[self.getLatitudeCol()][i])
        lon = float(df[self.getLongitudeCol()][i])
        return (f"{self.get('url').rstrip('/')}/spatial/pointInPolygon/json"
                f"?api-version={self.getApiVersion()}&udid={udid}"
                f"&lat={lat}&lon={lon}" + self._key_query(df, i))

    def _prepare_body(self, df, i):
        if not self._resolve("userDataIdentifier", df, i):
            raise ValueError("CheckPointInPolygon: userDataIdentifier not set")
        return b"" if _coords_present(df, self, i) else None

    def _parse_response(self, parsed, df, i):
        try:
            return parsed["result"]
        except (KeyError, TypeError):
            return parsed
