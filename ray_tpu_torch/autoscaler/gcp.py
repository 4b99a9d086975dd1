"""GCE metadata for the node daemon and the REST transport (the part of
ray_tpu/autoscaler/gcp.py that names no TPU: its GKE / queued-resource
slice providers wait for the port's autoscaler slice).

- ``GceMaintenanceEventSource``: the preemption-notice source
  ``NodeManager._preemption_source`` builds on a Google VM (the DMI
  product name says "Google", as GCE's A3 H100 machines report): it polls
  the metadata server's ``preempted`` and ``maintenance-event`` values,
  and a notice makes the node drain itself within the notice window.
- ``GcpTransport``: bearer-token REST calls (``GOOGLE_OAUTH_ACCESS_TOKEN``,
  else the metadata server's service-account token), with
  ``GcpHttpError``; data/bigquery.py's default transport.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Callable


_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/service-accounts/default/token"
)


_MAINTENANCE_EVENT_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/maintenance-event"
)
_PREEMPTED_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/preempted"
)


class GceMaintenanceEventSource:
    """Preemption-notice source for the node daemon's drain watcher
    (runtime/node.py): polls the GCE metadata server's maintenance-event
    and preempted endpoints. A value other than NONE/FALSE means this VM
    is about to be migrated or preempted — the node self-reports DRAIN
    with the standard notice window so the trainer's emergency
    checkpoint and the autoscaler's replacement both start inside it.

    Only constructed on GCE hosts (the DMI product-name gate in
    NodeManager._preemption_source keeps other machines off the
    metadata endpoint). ``fetch`` is a seam for tests."""

    interval_s = 5.0

    def __init__(self, fetch: Callable[[str], str] | None = None):
        self._fetch = fetch or self._metadata_get

    @staticmethod
    def _metadata_get(url: str) -> str:
        req = urllib.request.Request(
            url, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=2) as resp:
            return resp.read().decode().strip()

    def poll(self, node) -> "tuple[str, float] | None":
        del node
        from ray_tpu_torch._private import config

        try:
            if self._fetch(_PREEMPTED_URL).upper() == "TRUE":
                return ("gce-preempted", config.get("DRAIN_DEADLINE_S"))
        except OSError:
            pass
        try:
            event = self._fetch(_MAINTENANCE_EVENT_URL)
        except OSError:
            return None
        if event and event.upper() != "NONE":
            return (
                f"gce-maintenance:{event}",
                config.get("DRAIN_DEADLINE_S"),
            )
        return None


class GcpHttpError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body[:500]}")
        self.status = status
        self.body = body


class GcpTransport:
    """Minimal authorized REST transport (the AuthorizedHttp analogue,
    reference node.py:240)."""

    def __init__(
        self,
        token_provider: Callable[[], "str | tuple[str, float]"] | None = None,
    ):
        self._token_provider = token_provider or self._default_token
        self._token: str | None = None
        self._token_expiry = 0.0

    @staticmethod
    def _default_token() -> tuple[str, float]:
        import os

        env = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if env:
            return env, 600.0
        req = urllib.request.Request(
            _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = json.loads(resp.read())
        return payload["access_token"], float(payload.get("expires_in", 600))

    def _bearer(self) -> str:
        if self._token is None or time.time() > self._token_expiry:
            got = self._token_provider()
            # Providers may return a bare token or (token, expires_in).
            token, expires_in = got if isinstance(got, tuple) else (got, 600.0)
            self._token = token
            # Honor the server's actual lifetime, minus a safety margin so
            # a token fetched near expiry isn't cached past its death.
            self._token_expiry = time.time() + max(expires_in - 60.0, 10.0)
        return self._token

    def _invalidate_token(self) -> None:
        self._token = None
        self._token_expiry = 0.0

    def request(
        self, method: str, url: str, body: dict | None = None
    ) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        for attempt in (0, 1):
            req = urllib.request.Request(
                url,
                data=data,
                method=method,
                headers={
                    "Authorization": f"Bearer {self._bearer()}",
                    "Content-Type": "application/json",
                },
            )
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    payload = resp.read()
                break
            except urllib.error.HTTPError as e:
                if e.code == 401 and attempt == 0:
                    # Stale cached token: drop it and retry once fresh.
                    self._invalidate_token()
                    continue
                raise GcpHttpError(e.code, e.read().decode("utf-8", "replace"))
        return json.loads(payload) if payload else {}
