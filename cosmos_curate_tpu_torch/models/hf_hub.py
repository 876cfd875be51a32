"""SDK-free Hugging Face Hub file download for weight bootstrap (port of
``cosmos_curate_tpu/models/hf_hub.py``).

Plain HTTPS GETs against the hub's ``/{repo}/resolve/{revision}/{file}``
layout with

- streaming download and Range resume (a killed multi-GB pull continues
  instead of restarting);
- a file lock per destination and an atomic rename (the workers of one
  host pay the download once; no reader sees a partial file);
- integrity: an explicit ``expected_sha256`` wins; otherwise the hub's
  ``X-Linked-ETag`` (the LFS sha256) is checked where the hub sends it;
- ``HF_TOKEN`` bearer auth for gated repos;
- the endpoint from ``CURATE_HF_ENDPOINT`` / ``HF_ENDPOINT`` (tests run
  against a local fake; mirrors inside a closed network work the same
  way).

The files pulled are the hub's own (safetensors and tokenizer files);
turning them into this framework's checkpoint format is the converters'
work (ROADMAP queue A), driven through ``models pull-hf``. Host code: no
torch.
"""

from __future__ import annotations

import hashlib
import os
import urllib.error
import urllib.request
from pathlib import Path

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_CHUNK = 8 * 1024 * 1024


class HubDownloadError(RuntimeError):
    pass


def hub_endpoint() -> str:
    return (
        os.environ.get("CURATE_HF_ENDPOINT")
        or os.environ.get("HF_ENDPOINT")
        or "https://huggingface.co"
    ).rstrip("/")


def hub_url(repo_id: str, filename: str, revision: str = "main") -> str:
    return f"{hub_endpoint()}/{repo_id}/resolve/{revision}/{filename}"


def _request(url: str, *, headers: dict[str, str]) -> urllib.request.Request:
    h = dict(headers)
    token = os.environ.get("HF_TOKEN", "")
    if token:
        h["Authorization"] = f"Bearer {token}"
    return urllib.request.Request(url, headers=h)


def download_file(
    repo_id: str,
    filename: str,
    dest: str | Path,
    *,
    revision: str = "main",
    expected_sha256: str = "",
    timeout: float = 60.0,
) -> Path:
    """Download one repo file to ``dest`` (resumable, locked, verified).
    Returns ``dest``; raises HubDownloadError on HTTP failure or an
    integrity mismatch (the partial file is kept for resume only when the
    bytes were sound)."""
    from cosmos_curate_tpu_torch.utils.file_lock import file_lock

    dest = Path(dest)
    if dest.exists():
        # an existing file short-circuits the download but NOT an explicit
        # integrity request: re-running with --sha256 must actually verify
        if expected_sha256:
            _verify_file(dest, expected_sha256, label=str(dest))
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    url = hub_url(repo_id, filename, revision)
    tmp = dest.with_name(dest.name + ".part")
    with file_lock(dest.parent / f".{dest.name}.lock"):
        if dest.exists():  # another worker won while we waited
            return dest
        offset = tmp.stat().st_size if tmp.exists() else 0
        headers = {"Range": f"bytes={offset}-"} if offset else {}
        try:
            resp = urllib.request.urlopen(_request(url, headers=headers), timeout=timeout)
        except urllib.error.HTTPError as e:
            if e.code == 416 and offset:  # already fully downloaded
                resp = None
            else:
                raise HubDownloadError(
                    f"hub download failed for {url}: HTTP {e.code}"
                ) from e
        except urllib.error.URLError as e:
            raise HubDownloadError(f"hub unreachable for {url}: {e}") from e
        if resp is not None:
            with resp:
                if offset and resp.status != 206:
                    # server ignored the Range header: restart from zero
                    logger.info("resume unsupported for %s; restarting", url)
                    offset = 0
                mode = "ab" if offset else "wb"
                with tmp.open(mode) as fh:
                    while True:
                        chunk = resp.read(_CHUNK)
                        if not chunk:
                            break
                        fh.write(chunk)
                want = expected_sha256 or _linked_sha(resp.headers)
        else:
            want = expected_sha256
        if want:
            try:
                _verify_file(tmp, want, label=url)
            except HubDownloadError:
                tmp.unlink(missing_ok=True)  # corrupt: resume would keep it
                raise
        tmp.rename(dest)
    logger.info("pulled %s/%s@%s -> %s", repo_id, filename, revision, dest)
    return dest


def _verify_file(path: Path, want: str, *, label: str) -> None:
    digest = hashlib.sha256()
    with path.open("rb") as fh:
        while True:
            chunk = fh.read(_CHUNK)
            if not chunk:
                break
            digest.update(chunk)
    if digest.hexdigest() != want.lower():
        raise HubDownloadError(
            f"integrity check failed for {label}: "
            f"sha256 {digest.hexdigest()} != {want}"
        )


def _linked_sha(headers) -> str:
    """The hub serves LFS files with X-Linked-ETag: \"<sha256>\"."""
    etag = headers.get("X-Linked-ETag", "") or ""
    etag = etag.strip('"')
    return etag if len(etag) == 64 and all(c in "0123456789abcdef" for c in etag.lower()) else ""


def pull_repo_files(
    repo_id: str,
    filenames: list[str],
    dest_dir: str | Path,
    *,
    revision: str = "main",
    expected_sha256: dict[str, str] | None = None,
) -> list[Path]:
    """Download several files of one repo into ``dest_dir``, PRESERVING
    repo subpaths ('text_encoder/config.json' keeps its directory — two
    files sharing a basename must not collide)."""
    shas = expected_sha256 or {}
    return [
        download_file(
            repo_id, name, Path(dest_dir) / name, revision=revision,
            expected_sha256=shas.get(name, ""),
        )
        for name in filenames
    ]
