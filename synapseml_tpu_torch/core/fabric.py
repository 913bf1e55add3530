"""Fabric / AAD token plumbing.

Reference: core/.../fabric/{FabricClient,TokenLibrary,OpenAITokenLibrary}.scala
and logging/common/PlatformDetails.scala — platform detection (Synapse /
Fabric / other) plus ambient-token acquisition used for keyless auth of the
service transformers. Here: environment-driven detection and a pluggable token
provider chain; on non-Fabric hosts everything degrades to explicit keys.

The port's copy of the JAX package's ``core/fabric.py``, over the port's
``io/http.py``; the environment variables keep their names.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

PLATFORM_SYNAPSE = "synapse"
PLATFORM_FABRIC = "fabric"
PLATFORM_DATABRICKS = "databricks"
PLATFORM_OTHER = "other"

_providers: List[Callable[[str], Optional[str]]] = []


def current_platform() -> str:
    """Platform detection (reference PlatformDetails.scala — cluster env
    vars)."""
    env = os.environ
    if "AZURE_SERVICE" in env and "fabric" in env.get("AZURE_SERVICE", "").lower():
        return PLATFORM_FABRIC
    if env.get("MMLSPARK_PLATFORM") in (PLATFORM_SYNAPSE, PLATFORM_FABRIC,
                                        PLATFORM_DATABRICKS):
        return env["MMLSPARK_PLATFORM"]
    if "SYNAPSE_WORKSPACE" in env or "AZURE_SYNAPSE_HOST" in env:
        return PLATFORM_SYNAPSE
    if "DATABRICKS_RUNTIME_VERSION" in env:
        return PLATFORM_DATABRICKS
    return PLATFORM_OTHER


def register_token_provider(fn: Callable[[str], Optional[str]]) -> None:
    """Register a provider ``audience -> token`` (the TokenLibrary hook; on
    Fabric the platform injects one)."""
    _providers.append(fn)


def get_access_token(audience: str = "cognitive") -> Optional[str]:
    """First token any provider yields, else the ``SYNAPSEML_TPU_AAD_TOKEN``
    env var, else None (callers fall back to subscription keys) —
    TokenLibrary.getAccessToken analog."""
    for p in _providers:
        try:
            tok = p(audience)
        except Exception:  # noqa: BLE001
            tok = None
        if tok:
            return tok
    return os.environ.get("SYNAPSEML_TPU_AAD_TOKEN") or None


class FabricClient:
    """Minimal Fabric REST surface (reference FabricClient.scala: workspace /
    artifact endpoints with ambient auth). Network calls go through io/http."""

    def __init__(self, base_url: str = "https://api.fabric.microsoft.com/v1",
                 token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.token = token or get_access_token("fabric")

    def _headers(self) -> dict:
        if not self.token:
            raise PermissionError(
                "no Fabric token available: register a token provider or set "
                "SYNAPSEML_TPU_AAD_TOKEN")
        return {"Authorization": f"Bearer {self.token}",
                "Content-Type": "application/json"}

    def get(self, path: str):
        from ..io.http import HTTPRequestData, send_with_retries

        resp = send_with_retries(HTTPRequestData(
            url=f"{self.base_url}/{path.lstrip('/')}", method="GET",
            headers=self._headers()))
        if not 200 <= resp.status_code < 300:
            raise RuntimeError(f"Fabric GET {path}: {resp.status_code} "
                               f"{resp.reason}")
        return resp.json()
