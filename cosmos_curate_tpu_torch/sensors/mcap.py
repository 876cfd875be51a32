"""MCAP reader and writer without the SDK, from the public MCAP spec (port of
``cosmos_curate_tpu/sensors/mcap.py``).

Little-endian records, prefixed strings and maps, chunked and unchunked
data sections, ``none`` and ``zstd`` chunks (``zstandard`` imported when a
chunk needs it; an ``lz4`` chunk raises ``McapError`` where ``lz4`` is
absent), chunk CRCs, metadata records, the summary section (schemas,
channels, chunk indexes, statistics) with a data-section scan for files
without one, and time- and topic-filtered message iteration that skips
chunks outside the window through the chunk indexes. The writer's bytes are
the JAX package's for the same calls; it backs ``make_mcap_from_video``.
"""

from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_CHUNK = 0x06
OP_MESSAGE_INDEX = 0x07
OP_CHUNK_INDEX = 0x08
OP_ATTACHMENT = 0x09
OP_ATTACHMENT_INDEX = 0x0A
OP_STATISTICS = 0x0B
OP_METADATA = 0x0C
OP_METADATA_INDEX = 0x0D
OP_SUMMARY_OFFSET = 0x0E
OP_DATA_END = 0x0F


class McapError(ValueError):
    pass


# ---------------------------------------------------------------------------
# primitive encode/decode


def _u16(v: int) -> bytes:
    return struct.pack("<H", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _string(s: str) -> bytes:
    b = s.encode()
    return _u32(len(b)) + b


def _str_map(m: dict[str, str]) -> bytes:
    body = b"".join(_string(k) + _string(v) for k, v in m.items())
    return _u32(len(body)) + body


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0) -> None:
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from("<H", self.buf, self.pos)
        self.pos += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.buf, self.pos)
        self.pos += 8
        return v

    def raw(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        if len(v) != n:
            raise McapError("truncated record")
        self.pos += n
        return v

    def string(self) -> str:
        return self.raw(self.u32()).decode()

    def str_map(self) -> dict[str, str]:
        end = self.u32() + self.pos
        out: dict[str, str] = {}
        while self.pos < end:
            k = self.string()
            out[k] = self.string()
        return out


# ---------------------------------------------------------------------------
# records


@dataclass(frozen=True)
class Schema:
    id: int
    name: str
    encoding: str
    data: bytes


@dataclass(frozen=True)
class Channel:
    id: int
    schema_id: int
    topic: str
    message_encoding: str
    metadata: dict[str, str] = field(default_factory=dict)


@dataclass(frozen=True)
class Message:
    channel_id: int
    sequence: int
    log_time: int
    publish_time: int
    data: bytes


@dataclass(frozen=True)
class ChunkIndex:
    message_start_time: int
    message_end_time: int
    chunk_start_offset: int
    chunk_length: int
    compression: str
    compressed_size: int
    uncompressed_size: int


@dataclass(frozen=True)
class Statistics:
    message_count: int
    schema_count: int
    channel_count: int
    attachment_count: int
    metadata_count: int
    chunk_count: int
    message_start_time: int
    message_end_time: int
    channel_message_counts: dict[int, int]


@dataclass(frozen=True)
class MetadataRecord:
    name: str
    metadata: dict[str, str]


@dataclass
class Summary:
    schemas: dict[int, Schema] = field(default_factory=dict)
    channels: dict[int, Channel] = field(default_factory=dict)
    chunk_indexes: list[ChunkIndex] = field(default_factory=list)
    statistics: Statistics | None = None


def _decompress(compression: str, data: bytes, uncompressed_size: int) -> bytes:
    if compression in ("", "none"):
        return data
    if compression == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=uncompressed_size or -1
        )
    if compression == "lz4":
        try:
            import lz4.frame
        except ImportError as e:
            raise McapError("lz4-compressed MCAP chunk but lz4 is not installed") from e
        return lz4.frame.decompress(data)
    raise McapError(f"unknown MCAP chunk compression {compression!r}")


def _compress(compression: str, data: bytes) -> bytes:
    if compression in ("", "none"):
        return data
    if compression == "zstd":
        import zstandard

        return zstandard.ZstdCompressor().compress(data)
    raise McapError(f"unsupported writer compression {compression!r}")


# ---------------------------------------------------------------------------
# reader


class McapReader:
    """Random-access MCAP reader over a seekable binary stream."""

    def __init__(self, stream: BinaryIO) -> None:
        self._f = stream
        self._f.seek(0)
        if self._f.read(len(MAGIC)) != MAGIC:
            raise McapError("not an MCAP file (bad leading magic)")
        self._summary: Summary | None = None

    # -- low-level record walk --------------------------------------------

    def _iter_records(
        self, start: int, end: int | None = None
    ) -> Iterator[tuple[int, bytes, int]]:
        """Yield (opcode, content, record_start_offset) from the file."""
        f = self._f
        f.seek(start)
        while True:
            offset = f.tell()
            if end is not None and offset >= end:
                return
            head = f.read(9)
            if len(head) < 9:
                return
            op = head[0]
            (length,) = struct.unpack("<Q", head[1:])
            content = f.read(length)
            if len(content) != length:
                raise McapError(f"truncated record op=0x{op:02x} at {offset}")
            yield op, content, offset
            if op == OP_FOOTER:
                return

    @staticmethod
    def _iter_chunk_records(chunk_content: bytes) -> Iterator[tuple[int, bytes]]:
        cur = _Cursor(chunk_content)
        start_time = cur.u64()  # noqa: F841 — spec fields, kept for clarity
        end_time = cur.u64()  # noqa: F841
        uncompressed_size = cur.u64()
        uncompressed_crc = cur.u32()
        compression = cur.string()
        records = cur.raw(cur.u64())
        data = _decompress(compression, records, uncompressed_size)
        if uncompressed_crc and zlib.crc32(data) != uncompressed_crc:
            raise McapError("MCAP chunk CRC mismatch")
        inner = _Cursor(data)
        while inner.pos < len(data):
            op = inner.u8()
            length = inner.u64()
            yield op, inner.raw(length)

    # -- record parsers ----------------------------------------------------

    @staticmethod
    def _parse_schema(content: bytes) -> Schema:
        cur = _Cursor(content)
        return Schema(cur.u16(), cur.string(), cur.string(), cur.raw(cur.u32()))

    @staticmethod
    def _parse_channel(content: bytes) -> Channel:
        cur = _Cursor(content)
        return Channel(cur.u16(), cur.u16(), cur.string(), cur.string(), cur.str_map())

    @staticmethod
    def _parse_message(content: bytes) -> Message:
        cur = _Cursor(content)
        return Message(cur.u16(), cur.u32(), cur.u64(), cur.u64(), content[cur.pos :])

    @staticmethod
    def _parse_chunk_index(content: bytes) -> ChunkIndex:
        cur = _Cursor(content)
        start, end = cur.u64(), cur.u64()
        chunk_start, chunk_len = cur.u64(), cur.u64()
        cur.raw(cur.u32())  # message_index_offsets
        cur.u64()  # message_index_length
        compression = cur.string()
        return ChunkIndex(start, end, chunk_start, chunk_len, compression, cur.u64(), cur.u64())

    @staticmethod
    def _parse_statistics(content: bytes) -> Statistics:
        cur = _Cursor(content)
        msg_count = cur.u64()
        schema_count, channel_count = cur.u16(), cur.u32()
        attach_count, meta_count, chunk_count = cur.u32(), cur.u32(), cur.u32()
        start, end = cur.u64(), cur.u64()
        counts: dict[int, int] = {}
        map_end = cur.u32() + cur.pos
        while cur.pos < map_end:
            cid = cur.u16()
            counts[cid] = cur.u64()
        return Statistics(
            msg_count, schema_count, channel_count, attach_count, meta_count,
            chunk_count, start, end, counts,
        )

    # -- summary -----------------------------------------------------------

    def get_summary(self) -> Summary:
        """Parse the summary section (via the footer); falls back to a full
        data-section scan for files written without one."""
        if self._summary is not None:
            return self._summary
        f = self._f
        f.seek(0, io.SEEK_END)
        file_end = f.tell()
        footer_start = file_end - len(MAGIC) - (9 + 8 + 8 + 4)
        f.seek(footer_start)
        head = f.read(9)
        summary = Summary()
        if len(head) == 9 and head[0] == OP_FOOTER:
            cur = _Cursor(f.read(20))
            summary_start = cur.u64()
            if f.read(len(MAGIC)) != MAGIC:
                raise McapError("bad trailing magic")
            if summary_start:
                for op, content, _ in self._iter_records(summary_start, file_end):
                    if op == OP_SCHEMA:
                        s = self._parse_schema(content)
                        summary.schemas[s.id] = s
                    elif op == OP_CHANNEL:
                        c = self._parse_channel(content)
                        summary.channels[c.id] = c
                    elif op == OP_CHUNK_INDEX:
                        summary.chunk_indexes.append(self._parse_chunk_index(content))
                    elif op == OP_STATISTICS:
                        summary.statistics = self._parse_statistics(content)
                self._summary = summary
                return summary
        # no summary section: scan the data section
        for op, content, _ in self._iter_records(len(MAGIC)):
            if op == OP_SCHEMA:
                s = self._parse_schema(content)
                summary.schemas[s.id] = s
            elif op == OP_CHANNEL:
                c = self._parse_channel(content)
                summary.channels[c.id] = c
            elif op == OP_CHUNK:
                for iop, icontent in self._iter_chunk_records(content):
                    if iop == OP_SCHEMA:
                        s = self._parse_schema(icontent)
                        summary.schemas[s.id] = s
                    elif iop == OP_CHANNEL:
                        c = self._parse_channel(icontent)
                        summary.channels[c.id] = c
            elif op in (OP_DATA_END, OP_FOOTER):
                break
        self._summary = summary
        return summary

    # -- public iteration --------------------------------------------------

    def iter_metadata(self) -> Iterator[MetadataRecord]:
        for op, content, _ in self._iter_records(len(MAGIC)):
            if op == OP_METADATA:
                cur = _Cursor(content)
                yield MetadataRecord(cur.string(), cur.str_map())
            elif op in (OP_DATA_END, OP_FOOTER):
                return

    def iter_message_times(self, topics: str | list[str] | None = None) -> Iterator[int]:
        """Yield message log_times (file order, payloads discarded as they
        stream) — the memory-safe way to build a timeline."""
        if isinstance(topics, str):
            topics = [topics]
        summary = self.get_summary()
        want = (
            None
            if topics is None
            else {c.id for c in summary.channels.values() if c.topic in topics}
        )
        channels: dict[int, Channel] = dict(summary.channels)
        for op, content, _ in self._iter_records(len(MAGIC)):
            if op == OP_CHANNEL:
                c = self._parse_channel(content)
                channels[c.id] = c
            elif op == OP_MESSAGE:
                m = self._parse_message(content)
                if want is None or m.channel_id in want:
                    yield m.log_time
            elif op == OP_CHUNK:
                for iop, icontent in self._iter_chunk_records(content):
                    if iop == OP_CHANNEL:
                        c = self._parse_channel(icontent)
                        channels[c.id] = c
                    elif iop == OP_MESSAGE:
                        cur = _Cursor(icontent)
                        cid = cur.u16()
                        if want is None or cid in want:
                            cur.u32()  # sequence
                            yield cur.u64()  # log_time (payload never sliced)
            elif op in (OP_DATA_END, OP_FOOTER):
                return

    def iter_messages(
        self,
        topics: str | list[str] | None = None,
        start_time: int | None = None,
        end_time: int | None = None,
        *,
        log_time_order: bool = True,
        reverse: bool = False,
    ) -> Iterator[tuple[Schema | None, Channel, Message]]:
        """Yield ``(schema, channel, message)`` with ``start_time <= log_time <
        end_time`` on the given topic(s). Chunk indexes (when present) are
        used to skip chunks entirely outside the window."""
        if isinstance(topics, str):
            topics = [topics]
        summary = self.get_summary()
        want = (
            None
            if topics is None
            else {c.id for c in summary.channels.values() if c.topic in topics}
        )

        skip_ranges: list[tuple[int, int]] = []
        if summary.chunk_indexes and (start_time is not None or end_time is not None):
            for ci in summary.chunk_indexes:
                if (end_time is not None and ci.message_start_time >= end_time) or (
                    start_time is not None and ci.message_end_time < start_time
                ):
                    skip_ranges.append((ci.chunk_start_offset, ci.chunk_length))
        skip = {off for off, _ in skip_ranges}

        channels: dict[int, Channel] = dict(summary.channels)
        schemas: dict[int, Schema] = dict(summary.schemas)
        out: list[Message] = []

        def consider(m: Message) -> None:
            if want is not None and m.channel_id not in want:
                return
            if start_time is not None and m.log_time < start_time:
                return
            if end_time is not None and m.log_time >= end_time:
                return
            out.append(m)

        for op, content, offset in self._iter_records(len(MAGIC)):
            if op == OP_SCHEMA:
                s = self._parse_schema(content)
                schemas[s.id] = s
            elif op == OP_CHANNEL:
                c = self._parse_channel(content)
                channels[c.id] = c
            elif op == OP_MESSAGE:
                consider(self._parse_message(content))
            elif op == OP_CHUNK:
                if offset in skip:
                    continue
                for iop, icontent in self._iter_chunk_records(content):
                    if iop == OP_SCHEMA:
                        s = self._parse_schema(icontent)
                        schemas[s.id] = s
                    elif iop == OP_CHANNEL:
                        c = self._parse_channel(icontent)
                        channels[c.id] = c
                    elif iop == OP_MESSAGE:
                        consider(self._parse_message(icontent))
            elif op in (OP_DATA_END, OP_FOOTER):
                break

        if log_time_order:
            out.sort(key=lambda m: m.log_time, reverse=reverse)
        elif reverse:
            out.reverse()
        for m in out:
            ch = channels[m.channel_id]
            yield schemas.get(ch.schema_id), ch, m


def make_reader(stream: BinaryIO) -> McapReader:
    return McapReader(stream)


# ---------------------------------------------------------------------------
# writer


class McapWriter:
    """Writes spec-valid MCAP: one chunk per ``flush`` (or unchunked),
    metadata records, and a summary section with chunk indexes/statistics."""

    def __init__(
        self,
        stream: BinaryIO,
        *,
        profile: str = "",
        library: str = "cosmos-curate-tpu",
        compression: str = "zstd",
        chunk_size: int = 4 * 1024 * 1024,
    ) -> None:
        self._f = stream
        self._compression = compression
        self._chunk_size = chunk_size
        self._schemas: dict[int, Schema] = {}
        self._channels: dict[int, Channel] = {}
        self._chunk_buf = bytearray()
        self._chunk_start_time: int | None = None
        self._chunk_end_time: int | None = None
        self._chunk_indexes: list[ChunkIndex] = []
        self._metadata_count = 0
        self._message_count = 0
        self._msg_start: int | None = None
        self._msg_end: int | None = None
        self._channel_counts: dict[int, int] = {}
        self._finished = False
        self._f.write(MAGIC)
        self._record(OP_HEADER, _string(profile) + _string(library))

    def _record(self, op: int, content: bytes) -> None:
        self._f.write(bytes([op]) + _u64(len(content)) + content)

    @staticmethod
    def _encode(op: int, content: bytes) -> bytes:
        return bytes([op]) + _u64(len(content)) + content

    def register_schema(self, name: str, encoding: str, data: bytes) -> int:
        sid = len(self._schemas) + 1
        self._schemas[sid] = Schema(sid, name, encoding, data)
        self._chunk_buf += self._encode(
            OP_SCHEMA, _u16(sid) + _string(name) + _string(encoding) + _u32(len(data)) + data
        )
        return sid

    def register_channel(
        self,
        topic: str,
        message_encoding: str,
        schema_id: int = 0,
        metadata: dict[str, str] | None = None,
    ) -> int:
        cid = len(self._channels)
        self._channels[cid] = Channel(cid, schema_id, topic, message_encoding, metadata or {})
        self._chunk_buf += self._encode(
            OP_CHANNEL,
            _u16(cid)
            + _u16(schema_id)
            + _string(topic)
            + _string(message_encoding)
            + _str_map(metadata or {}),
        )
        return cid

    def add_message(
        self, channel_id: int, log_time: int, data: bytes, *, publish_time: int | None = None,
        sequence: int = 0,
    ) -> None:
        if channel_id not in self._channels:
            raise McapError(f"unknown channel id {channel_id}")
        pub = log_time if publish_time is None else publish_time
        self._chunk_buf += self._encode(
            OP_MESSAGE, _u16(channel_id) + _u32(sequence) + _u64(log_time) + _u64(pub) + data
        )
        self._message_count += 1
        self._channel_counts[channel_id] = self._channel_counts.get(channel_id, 0) + 1
        self._msg_start = log_time if self._msg_start is None else min(self._msg_start, log_time)
        self._msg_end = log_time if self._msg_end is None else max(self._msg_end, log_time)
        if self._chunk_start_time is None or log_time < self._chunk_start_time:
            self._chunk_start_time = log_time
        if self._chunk_end_time is None or log_time > self._chunk_end_time:
            self._chunk_end_time = log_time
        if len(self._chunk_buf) >= self._chunk_size:
            self.flush_chunk()

    def add_metadata(self, name: str, metadata: dict[str, str]) -> None:
        self.flush_chunk()
        self._record(OP_METADATA, _string(name) + _str_map(metadata))
        self._metadata_count += 1

    def flush_chunk(self) -> None:
        if not self._chunk_buf:
            return
        data = bytes(self._chunk_buf)
        self._chunk_buf = bytearray()
        compressed = _compress(self._compression, data)
        start = self._chunk_start_time or 0
        end = self._chunk_end_time or 0
        self._chunk_start_time = self._chunk_end_time = None
        content = (
            _u64(start)
            + _u64(end)
            + _u64(len(data))
            + _u32(zlib.crc32(data))
            + _string(self._compression)
            + _u64(len(compressed))
            + compressed
        )
        chunk_offset = self._f.tell()
        self._record(OP_CHUNK, content)
        chunk_length = self._f.tell() - chunk_offset
        self._chunk_indexes.append(
            ChunkIndex(start, end, chunk_offset, chunk_length, self._compression,
                       len(compressed), len(data))
        )

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self.flush_chunk()
        self._record(OP_DATA_END, _u32(0))
        summary_start = self._f.tell()
        for s in self._schemas.values():
            self._record(
                OP_SCHEMA,
                _u16(s.id) + _string(s.name) + _string(s.encoding) + _u32(len(s.data)) + s.data,
            )
        for c in self._channels.values():
            self._record(
                OP_CHANNEL,
                _u16(c.id) + _u16(c.schema_id) + _string(c.topic)
                + _string(c.message_encoding) + _str_map(c.metadata),
            )
        for ci in self._chunk_indexes:
            self._record(
                OP_CHUNK_INDEX,
                _u64(ci.message_start_time) + _u64(ci.message_end_time)
                + _u64(ci.chunk_start_offset) + _u64(ci.chunk_length)
                + _u32(0)  # empty message_index_offsets map
                + _u64(0)  # message_index_length
                + _string(ci.compression)
                + _u64(ci.compressed_size) + _u64(ci.uncompressed_size),
            )
        counts = b"".join(_u16(cid) + _u64(n) for cid, n in self._channel_counts.items())
        self._record(
            OP_STATISTICS,
            _u64(self._message_count) + _u16(len(self._schemas)) + _u32(len(self._channels))
            + _u32(0) + _u32(self._metadata_count) + _u32(len(self._chunk_indexes))
            + _u64(self._msg_start or 0) + _u64(self._msg_end or 0)
            + _u32(len(counts)) + counts,
        )
        self._record(OP_FOOTER, _u64(summary_start) + _u64(0) + _u32(0))
        self._f.write(MAGIC)

    def __enter__(self) -> "McapWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


# ---------------------------------------------------------------------------
# helpers over the reader: channels, metadata records, timelines

VIDEO_METADATA_RECORD_NAME = "cosmos_curate.video_metadata.v1"


def channel_for_topic(summary: Summary, topic: str) -> Channel | None:
    matches = [ch for ch in summary.channels.values() if ch.topic == topic]
    if not matches:
        return None
    if len(matches) != 1:
        raise McapError(f"expected exactly one MCAP channel for topic {topic!r}")
    return matches[0]


def get_metadata_record(reader: McapReader, name: str) -> dict[str, str]:
    matches = [r.metadata for r in reader.iter_metadata() if r.name == name]
    if not matches:
        raise McapError(f"required MCAP metadata record {name!r} not found")
    if len(matches) != 1:
        raise McapError(f"expected exactly one MCAP metadata record {name!r}")
    return matches[0]


def load_timeline(reader: McapReader, topic: str):
    import numpy as np

    # payload-free scan: a multi-GB capture must not be resident just to
    # read its timestamps
    times = sorted(reader.iter_message_times(topics=topic))
    if not times:
        raise McapError(f"no MCAP messages on topic {topic!r}")
    arr = np.array(times, dtype=np.int64)
    arr.flags.writeable = False
    return arr


def load_start_end_ns(reader: McapReader, topic: str) -> tuple[int, int]:
    timeline = load_timeline(reader, topic)
    return int(timeline[0]), int(timeline[-1])
