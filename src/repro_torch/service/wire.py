"""Versioned JSON wire schema for the sweep service (port of
``repro.service.wire``: the same documents, byte for byte).

Request line (one JSON object per JSONL line)::

    {"version": 2, "requester": "alice", "spec": {...WindowSweep fields...}}

Response line (success)::

    {"version": 2, "request_id": "...", "requester": "alice",
     "cached": false, "result": {"spec": {...}, "records": [...]}}

Response line (failure — schema v2)::

    {"version": 2, "request_id": "line-7", "requester": "alice",
     "error": {"code": "parse", "message": "...", "lineno": 7}}

Schema v2 adds the optional ``"error"`` response field (a structured
per-request failure report: ``code`` in ``parse`` / ``schema`` / ``version``
/ ``oversize`` / ``reject`` / ``engine``, a human message, and the source
line when the failure is an intake failure).  Decoding is backward compatible: v1
documents (and v1 writers, which never emit ``"error"``) decode unchanged,
and requests are identical in both versions.

The ``spec``/``result`` payloads are exactly the canonical encodings of
``repro_torch.experiments.sweep`` (``spec_to_dict`` / ``SweepResult.as_dict`` —
``inf`` spelled as the string ``"inf"``), so a response body is the same
document ``SweepResult.to_json`` writes, wrapped in routing metadata.
"""
from __future__ import annotations

import dataclasses
import json

from ..experiments.sweep import (SweepResult, WindowSweep, spec_from_dict,
                                 spec_to_dict)
from .api import SweepResponse

__all__ = ["SCHEMA_VERSION", "SUPPORTED_VERSIONS", "WireError", "QueueItem",
           "encode_request", "decode_request", "encode_response",
           "decode_response", "encode_error", "read_queue",
           "write_responses", "serve_queue", "DEFAULT_MAX_LINE_BYTES"]

SCHEMA_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

#: intake guard: a single request line larger than this is answered with a
#: structured ``oversize`` error instead of being parsed (1 MiB is ~3 orders
#: of magnitude above any legitimate WindowSweep request).
DEFAULT_MAX_LINE_BYTES = 1 << 20


class UnsupportedVersion(ValueError):
    """A document's ``version`` field names a schema this build can't speak."""


@dataclasses.dataclass(frozen=True)
class WireError(Exception):
    """Structured per-request intake/serving failure.

    ``code`` is machine-readable: ``parse`` (not JSON), ``schema`` (JSON but
    not a well-formed request), ``version`` (unsupported schema version),
    ``oversize`` (line above the intake byte cap), ``reject`` (well-formed
    but refused by the service, e.g. a sharded spec, not ported yet),
    ``engine`` (the request was accepted but its device pass failed after
    retries).
    """

    code: str
    message: str
    lineno: int | None = None
    requester: str = "anon"
    request_id: str | None = None

    def __str__(self) -> str:  # Exception mixin: readable in tracebacks
        where = f" (line {self.lineno})" if self.lineno is not None else ""
        return f"[{self.code}]{where} {self.message}"


@dataclasses.dataclass(frozen=True)
class QueueItem:
    """One intake line: either a decoded request or a structured error."""

    lineno: int
    spec: WindowSweep | None = None
    requester: str = "anon"
    error: WireError | None = None


def _check_version(obj: dict, what: str) -> None:
    v = obj.get("version", SCHEMA_VERSION)
    if v not in SUPPORTED_VERSIONS:
        raise UnsupportedVersion(
            f"unsupported {what} schema version {v!r} "
            f"(this build speaks {', '.join(map(str, SUPPORTED_VERSIONS))})")


def encode_request(spec: WindowSweep, requester: str = "anon") -> dict:
    return {"version": SCHEMA_VERSION, "requester": requester,
            "spec": spec_to_dict(spec)}


def decode_request(obj: dict) -> tuple[WindowSweep, str]:
    """(spec, requester) from a request object; validates the version."""
    _check_version(obj, "request")
    return spec_from_dict(obj["spec"]), str(obj.get("requester", "anon"))


def encode_response(resp: SweepResponse) -> dict:
    out = {"version": SCHEMA_VERSION, "request_id": resp.request_id,
           "requester": resp.requester, "cached": resp.cached}
    if resp.error is not None:
        out["error"] = dict(resp.error)
    else:
        out["result"] = resp.result.as_dict()
    return out


def encode_error(err: WireError) -> dict:
    """Response document for a request that never reached the service."""
    body = {"code": err.code, "message": err.message}
    if err.lineno is not None:
        body["lineno"] = err.lineno
    rid = err.request_id or (
        f"line-{err.lineno}" if err.lineno is not None else "unknown")
    return {"version": SCHEMA_VERSION, "request_id": rid,
            "requester": err.requester, "error": body}


def decode_response(obj: dict) -> SweepResponse:
    _check_version(obj, "response")
    if "error" in obj:
        return SweepResponse(request_id=str(obj["request_id"]),
                             requester=str(obj.get("requester", "anon")),
                             spec=None, result=None, cached=False,
                             error=dict(obj["error"]))
    result = SweepResult.from_dict(obj["result"])
    return SweepResponse(request_id=str(obj["request_id"]),
                         requester=str(obj["requester"]),
                         spec=result.spec, result=result,
                         cached=bool(obj["cached"]))


def read_queue(path, *, max_line_bytes: int | None = DEFAULT_MAX_LINE_BYTES):
    """Lazily parse a JSONL queue file into :class:`QueueItem`\\ s.

    Yields one item per non-blank line, in file order, without ever loading
    the whole file: well-formed lines carry ``(spec, requester)``, bad lines
    carry a :class:`WireError` (``parse``/``schema``/``version``/
    ``oversize``) instead of aborting the rest of the queue.
    """
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            if max_line_bytes is not None and len(line) > max_line_bytes:
                yield QueueItem(lineno=lineno, error=WireError(
                    "oversize",
                    f"request line is {len(line)} bytes "
                    f"(cap {max_line_bytes})", lineno=lineno))
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                yield QueueItem(lineno=lineno, error=WireError(
                    "parse", f"not valid JSON: {e}", lineno=lineno))
                continue
            requester = "anon"
            if isinstance(obj, dict):
                requester = str(obj.get("requester", "anon"))
            try:
                spec, requester = decode_request(obj)
            except UnsupportedVersion as e:
                yield QueueItem(lineno=lineno, error=WireError(
                    "version", str(e), lineno=lineno, requester=requester))
                continue
            except Exception as e:
                yield QueueItem(lineno=lineno, error=WireError(
                    "schema", f"not a well-formed request: "
                    f"{type(e).__name__}: {e}",
                    lineno=lineno, requester=requester))
                continue
            yield QueueItem(lineno=lineno, spec=spec, requester=requester)


def write_responses(responses, fh) -> None:
    """Write responses as JSONL to an open text stream."""
    for resp in responses:
        fh.write(json.dumps(encode_response(resp)) + "\n")


def serve_queue(queue_path, out_fh, *, service=None,
                max_line_bytes: int | None = DEFAULT_MAX_LINE_BYTES
                ) -> "ServiceStats":
    """Drain a JSONL queue end-to-end; returns the service stats.

    The one-shot ``python -m repro_torch.service`` entry point: builds a
    service on the GPU (unless one is injected), submits every request line
    in file order, and
    writes one response line per input line, **in queue order**.

    Failure semantics (the hardening contract):

    * a malformed / oversized / unsupported-version line gets a structured
      ``error`` response at its queue position and the drain continues;
    * every response line is written *and flushed* as soon as it (and every
      line before it) is ready — a crash mid-drain keeps all
      already-computed responses on disk instead of losing the whole batch;
    * an engine failure (after the service's retry budget) surfaces as an
      ``engine`` error response for the affected requests only.
    """
    from .api import ServiceStats, SweepService  # noqa: F401 (return type)
    if service is None:
        service = SweepService()

    # one slot per queue line: either a ready-to-write error document or the
    # request_id whose response the slot waits for
    slots: list = []
    ready: dict[str, SweepResponse] = {}
    cursor = 0

    def flush() -> None:
        nonlocal cursor
        while cursor < len(slots):
            slot = slots[cursor]
            if isinstance(slot, dict):
                obj = slot
            elif slot in ready:
                obj = encode_response(ready[slot])
            else:
                return
            out_fh.write(json.dumps(obj) + "\n")
            out_fh.flush()
            cursor += 1

    def on_response(resp: SweepResponse) -> None:
        ready[resp.request_id] = resp
        flush()

    service.on_response = on_response
    for item in read_queue(queue_path, max_line_bytes=max_line_bytes):
        err = item.error
        if err is None:
            try:
                slots.append(
                    service.submit(item.spec, requester=item.requester)
                    .request_id)
                continue
            except Exception as e:     # e.g. a sharded spec (not ported)
                err = WireError("reject", f"{type(e).__name__}: {e}",
                                lineno=item.lineno, requester=item.requester)
        service.stats.n_errors += 1
        slots.append(encode_error(err))
    service.flush_ready()     # dedup/result-cache hits are ready immediately
    flush()
    while service.n_unserved:
        service.step(force=True)
    flush()
    return service.stats
