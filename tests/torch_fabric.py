"""Helpers of the port's fabric, federation, multitenant and online tests:
a POST with a timeout that never raises on an HTTP error status, the echo
handler, and a deadline-bounded wait on a condition (the tests poll a
condition instead of sleeping a fixed time)."""

import json
import time
import urllib.error
import urllib.request

from synapseml_tpu_torch.core.table import Table

WAIT_S = 10.0


def post(url, value, headers=None, timeout=10.0):
    """POST a JSON value; returns (status, parsed_or_text, elapsed_s) and
    never raises on HTTP error statuses."""
    body = json.dumps(value).encode()
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(url, data=body, headers=h, method="POST")
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            payload = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        payload = e.read()
        status = e.code
    elapsed = time.monotonic() - t0
    try:
        parsed = json.loads(payload.decode()) if payload else None
    except ValueError:
        parsed = payload
    return status, parsed, elapsed


def get_json(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def echo(df: Table) -> Table:
    return df.with_column("reply", df["value"])


def wait_for(cond, timeout=WAIT_S, interval=0.01, what="condition"):
    """Poll ``cond()`` until it is truthy; raise ``AssertionError`` naming
    ``what`` once ``timeout`` seconds pass. Returns the truthy value."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout}s waiting for "
                                 f"{what}")
        time.sleep(interval)
