"""Azure Storage Shared Key request signing, standard library only (port of
``cosmos_curate_tpu/storage/azure_shared_key.py``).

The Blob service's Shared Key scheme: an HMAC-SHA256 over a canonicalised
request string, keyed by the base64-decoded account key, carried as
``Authorization: SharedKey <account>:<signature>``. The string to sign
(2015-02-21 and later):

    VERB \n Content-Encoding \n Content-Language \n Content-Length \n
    Content-MD5 \n Content-Type \n Date \n If-Modified-Since \n If-Match \n
    If-None-Match \n If-Unmodified-Since \n Range \n
    CanonicalizedHeaders CanonicalizedResource

where Content-Length is empty when zero, CanonicalizedHeaders is every
``x-ms-*`` header lowercased and sorted as ``name:value\n``, and
CanonicalizedResource is ``/<account><url path>`` followed by each query
parameter (lowercased, sorted) as ``\n<name>:<value>``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
from dataclasses import dataclass
from email.utils import formatdate

API_VERSION = "2021-08-06"


@dataclass(frozen=True)
class AzureCredentials:
    account_name: str
    account_key: str  # base64-encoded, as the portal hands it out


def rfc1123_now() -> str:
    return formatdate(usegmt=True)


def string_to_sign(
    *,
    method: str,
    account: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    content_length: int,
) -> str:
    low = {k.lower(): v.strip() for k, v in headers.items()}
    ms_headers = "".join(
        f"{k}:{low[k]}\n" for k in sorted(low) if k.startswith("x-ms-")
    )
    resource = f"/{account}{path}"
    lowq = {k.lower(): v for k, v in query.items()}
    for name in sorted(lowq):
        resource += f"\n{name}:{lowq[name]}"
    return "\n".join(
        [
            method.upper(),
            low.get("content-encoding", ""),
            low.get("content-language", ""),
            str(content_length) if content_length else "",
            low.get("content-md5", ""),
            low.get("content-type", ""),
            "",  # Date — always empty: x-ms-date is set instead
            low.get("if-modified-since", ""),
            low.get("if-match", ""),
            low.get("if-none-match", ""),
            low.get("if-unmodified-since", ""),
            low.get("range", ""),
        ]
    ) + "\n" + ms_headers + resource


def sign_request(
    *,
    method: str,
    account: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    content_length: int,
    creds: AzureCredentials,
) -> dict[str, str]:
    """Return headers with ``x-ms-date``/``x-ms-version``/``Authorization``
    added. ``path`` is the URL path as sent on the wire (including any
    emulator account prefix); the canonicalized resource prepends the account
    name per spec."""
    out = dict(headers)
    out.setdefault("x-ms-date", rfc1123_now())
    out.setdefault("x-ms-version", API_VERSION)
    sts = string_to_sign(
        method=method,
        account=account,
        path=path,
        query=query,
        headers=out,
        content_length=content_length,
    )
    key = base64.b64decode(creds.account_key)
    sig = base64.b64encode(hmac.new(key, sts.encode(), hashlib.sha256).digest()).decode()
    out["Authorization"] = f"SharedKey {creds.account_name}:{sig}"
    return out
