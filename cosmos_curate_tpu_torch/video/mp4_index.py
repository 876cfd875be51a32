"""SDK-free MP4 sample-table parser: exact per-frame timestamps (copy of
``cosmos_curate_tpu/video/mp4_index.py``).

Equivalent capability of the reference's packet-timestamp probe
(cosmos_curate/pipelines/video/utils/decoder_utils.py:230
``get_video_timestamps`` via PyAV packet PTS): cv2 exposes no reliable
per-packet PTS, so variable-frame-rate videos got constant-rate
approximations. This module reads the container's own sample tables
(ISO/IEC 14496-12 boxes) with the stdlib only:

  moov/trak/mdia/hdlr('vide')     find the video track
  mdia/mdhd                       timescale (v0 32-bit / v1 64-bit)
  stbl/stts                       decode deltas -> DTS
  stbl/ctts                       composition offsets -> PTS = DTS + offset
  stbl/stss                       sync samples (keyframes; absent = all)

Exact for CFR *and* VFR mp4/mov files; videos in other containers (mkv,
webm) fall back to the caller's constant-rate path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

# containers worth descending into
_CONTAINER_BOXES = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


@dataclass(frozen=True)
class Mp4VideoIndex:
    timescale: int
    pts_s: np.ndarray  # float64 [N], presentation order (sorted ascending)
    keyframes: np.ndarray  # bool [N], in presentation order
    frame_count: int

    @property
    def duration_s(self) -> float:
        if self.frame_count == 0:
            return 0.0
        # last PTS + median delta approximates the tail frame's duration
        deltas = np.diff(self.pts_s)
        tail = float(np.median(deltas)) if len(deltas) else 0.0
        return float(self.pts_s[-1]) + tail


class Mp4ParseError(ValueError):
    pass


def _iter_boxes(data: memoryview, start: int, end: int) -> Iterator[tuple[bytes, int, int]]:
    """Yield (type, payload_start, payload_end) for boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        size = struct.unpack_from(">I", data, pos)[0]
        btype = bytes(data[pos + 4 : pos + 8])
        header = 8
        if size == 1:  # 64-bit largesize
            if pos + 16 > end:
                raise Mp4ParseError("truncated largesize box")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            header = 16
        elif size == 0:  # box extends to end of enclosing scope
            size = end - pos
        if size < header or pos + size > end:
            raise Mp4ParseError(f"bad box size {size} for {btype!r}")
        yield btype, pos + header, pos + size
        pos += size


def _find_box(data: memoryview, start: int, end: int, path: list[bytes]) -> tuple[int, int] | None:
    if not path:
        return start, end
    for btype, a, b in _iter_boxes(data, start, end):
        if btype == path[0]:
            found = _find_box(data, a, b, path[1:])
            if found is not None:
                return found
    return None


def _full_box(data: memoryview, start: int) -> tuple[int, int]:
    """(version, payload offset after version/flags)."""
    version = data[start]
    return version, start + 4


def _video_trak(data: memoryview, moov: tuple[int, int]) -> tuple[int, int] | None:
    for btype, a, b in _iter_boxes(data, *moov):
        if btype != b"trak":
            continue
        hdlr = _find_box(data, a, b, [b"mdia", b"hdlr"])
        if hdlr is None:
            continue
        handler = bytes(data[hdlr[0] + 8 : hdlr[0] + 12])
        if handler == b"vide":
            return a, b
    return None


def _read_moov_from_file(path: str) -> bytes:
    """Stream the top-level box headers and read ONLY the moov box — a
    multi-GB source must not be slurped to parse a few-KB sample table."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise Mp4ParseError("no moov box (not ISO-BMFF or fragmented)")
            size = struct.unpack(">I", header[:4])[0]
            btype = header[4:8]
            hlen = 8
            if size == 1:
                big = f.read(8)
                if len(big) < 8:
                    raise Mp4ParseError("truncated largesize box")
                size = struct.unpack(">Q", big)[0]
                hlen = 16
            elif size == 0:
                # box to EOF; only useful if it IS the moov
                if btype == b"moov":
                    return header + f.read()
                raise Mp4ParseError("no moov box before to-EOF box")
            if size < hlen:
                raise Mp4ParseError(f"bad box size {size} for {btype!r}")
            if btype == b"moov":
                body = f.read(size - hlen)
                if len(body) < size - hlen:
                    raise Mp4ParseError("truncated moov box")
                return header + (b"" if hlen == 8 else big) + body
            f.seek(size - hlen, 1)


def parse_mp4_video_index(source: bytes | str) -> Mp4VideoIndex:
    """Parse an mp4/mov's video sample tables into per-frame PTS.

    PTS are normalized so the first presented frame is at 0 — this absorbs
    the B-frame decoder-delay offset that muxers compensate with an edit
    list (the common single-entry elst case), without parsing elst itself.

    Raises Mp4ParseError when the data is not ISO-BMFF, has no video
    track, or has corrupt sample tables — callers fall back to
    constant-rate timestamps."""
    try:
        return _parse_impl(source)
    except Mp4ParseError:
        raise
    except (struct.error, IndexError, ValueError, OverflowError, MemoryError) as e:
        # corrupt/truncated tables must degrade to the fallback, not crash
        raise Mp4ParseError(f"corrupt sample tables: {e}") from e


def _parse_impl(source: bytes | str) -> Mp4VideoIndex:
    if isinstance(source, str):
        raw = _read_moov_from_file(source)
    else:
        raw = source
    data = memoryview(raw)
    moov = _find_box(data, 0, len(data), [b"moov"])
    if moov is None:
        raise Mp4ParseError("no moov box (not ISO-BMFF or fragmented)")
    trak = _video_trak(data, moov)
    if trak is None:
        raise Mp4ParseError("no video track")

    mdhd = _find_box(data, *trak, [b"mdia", b"mdhd"])
    if mdhd is None:
        raise Mp4ParseError("no mdhd")
    version, p = _full_box(data, mdhd[0])
    if version == 1:
        timescale = struct.unpack_from(">I", data, p + 16)[0]
    else:
        timescale = struct.unpack_from(">I", data, p + 8)[0]
    if timescale <= 0:
        raise Mp4ParseError(f"bad timescale {timescale}")

    stbl = _find_box(data, *trak, [b"mdia", b"minf", b"stbl"])
    if stbl is None:
        raise Mp4ParseError("no stbl")

    stts = _find_box(data, *stbl, [b"stts"])
    if stts is None:
        raise Mp4ParseError("no stts")
    _, p = _full_box(data, stts[0])
    (n_entries,) = struct.unpack_from(">I", data, p)
    counts = np.empty(n_entries, np.int64)
    deltas = np.empty(n_entries, np.int64)
    for i in range(n_entries):
        c, d = struct.unpack_from(">II", data, p + 4 + 8 * i)
        counts[i], deltas[i] = c, d
    durations = np.repeat(deltas, counts)
    n = int(counts.sum())
    dts = np.concatenate([[0], np.cumsum(durations[:-1])]) if n else np.zeros(0, np.int64)

    pts = dts.astype(np.int64)
    ctts = _find_box(data, *stbl, [b"ctts"])
    if ctts is not None:
        version, p = _full_box(data, ctts[0])
        (n_entries,) = struct.unpack_from(">I", data, p)
        counts_c = np.empty(n_entries, np.int64)
        offsets = np.empty(n_entries, np.int64)
        for i in range(n_entries):
            c = struct.unpack_from(">I", data, p + 4 + 8 * i)[0]
            # v1 offsets are signed; v0 unsigned (but commonly signed in
            # the wild — parse as signed either way, negative offsets are
            # real in v1 files)
            o = struct.unpack_from(">i" if version == 1 else ">I", data, p + 8 + 8 * i)[0]
            if version == 0 and o >= 2**31:
                o -= 2**32
            counts_c[i], offsets[i] = c, o
        full_offsets = np.repeat(offsets, counts_c)
        if len(full_offsets) < n:
            full_offsets = np.pad(full_offsets, (0, n - len(full_offsets)))
        pts = dts + full_offsets[:n]

    keyframes = np.ones(n, bool)
    stss = _find_box(data, *stbl, [b"stss"])
    if stss is not None:
        _, p = _full_box(data, stss[0])
        (n_sync,) = struct.unpack_from(">I", data, p)
        keyframes = np.zeros(n, bool)
        for i in range(n_sync):
            idx = struct.unpack_from(">I", data, p + 4 + 4 * i)[0] - 1  # 1-based
            if 0 <= idx < n:
                keyframes[idx] = True

    # present in presentation order, anchored at 0 (see docstring)
    order = np.argsort(pts, kind="stable")
    pts = pts[order]
    if n:
        pts = pts - pts[0]
    return Mp4VideoIndex(
        timescale=timescale,
        pts_s=pts.astype(np.float64) / timescale,
        keyframes=keyframes[order],
        frame_count=n,
    )
