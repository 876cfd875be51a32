"""AWS Signature Version 4 request signing, standard library only (port of
``cosmos_curate_tpu/storage/sigv4.py``).

The canonical request, the string to sign and the signing-key derivation of
the public SigV4 specification, so that the S3 REST backend
(``storage/s3_rest.py``) needs no SDK. A key is encoded by
:func:`_uri_encode` exactly as the request line carries it: spaces, ``+``,
``%`` and non-ASCII bytes all percent-encoded, ``/`` kept in paths.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclass(frozen=True)
class Credentials:
    access_key_id: str
    secret_access_key: str
    session_token: str = ""


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str, *, encode_slash: bool) -> str:
    safe = "-_.~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def canonical_query(params: dict[str, str]) -> str:
    pairs = sorted(
        (_uri_encode(k, encode_slash=True), _uri_encode(v, encode_slash=True))
        for k, v in params.items()
    )
    return "&".join(f"{k}={v}" for k, v in pairs)


def sign_request(
    *,
    method: str,
    host: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    payload_sha256: str,
    creds: Credentials,
    region: str,
    service: str = "s3",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """``headers`` plus the SigV4 ``Authorization`` header (and the date and
    token headers) for the described request. ``path`` must already be
    URI-encoded the way it will be sent on the wire."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    out = dict(headers)
    out["host"] = host
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_sha256
    if creds.session_token:
        out["x-amz-security-token"] = creds.session_token

    signed = sorted(k.lower() for k in out)
    canonical_headers = "".join(f"{k}:{str(out[_find(out, k)]).strip()}\n" for k in signed)
    signed_headers = ";".join(signed)

    canonical_request = "\n".join(
        [method.upper(), path or "/", canonical_query(query), canonical_headers, signed_headers, payload_sha256]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(canonical_request.encode()).hexdigest()]
    )
    k_date = _hmac(("AWS4" + creds.secret_access_key).encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()
    out["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={creds.access_key_id}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


def _find(d: dict[str, str], lower_key: str) -> str:
    for k in d:
        if k.lower() == lower_key:
            return k
    raise KeyError(lower_key)


def payload_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest() if data else _EMPTY_SHA256
