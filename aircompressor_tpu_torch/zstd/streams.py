"""Zstd streaming codecs: the port's counterpart of
``aircompressor_tpu.zstd.streams``, on the host.

- ``ZstdIncrementalFrameDecompressor`` — push/pull suspendable state machine
  (parity: reference zstd/ZstdIncrementalFrameDecompressor.java:44-384 —
  states INITIAL/READ_FRAME_MAGIC/READ_FRAME_HEADER/READ_BLOCK_HEADER/
  READ_BLOCK/READ_BLOCK_CHECKSUM with the input-required bookkeeping and a
  bounded sliding window that flushes bytes past the match lookback).
- ``ZstdInputStream`` — file-like reader over it (parity:
  zstd/ZstdInputStream.java:63-130 fill loop).
- ``ZstdOutputStream`` — TRUE streaming writer: ONE frame per stream with
  unknown content size; the match window, repcodes, entropy-table context
  and xxhash64 checksum are carried across ``write()`` calls (reference:
  zstd/ZstdOutputStream.java:154-221 + BlockCompressionState.slideWindow).
"""

from __future__ import annotations

import enum
import io

import numpy as np

from ..errors import MalformedInputException
from ..host import xxhash as xxh
from ..host.zstd import block_enc, frame_enc
from ..host.zstd import constants as C
from ..host.zstd.params import compute as _params
from . import frame_dec


class _State(enum.Enum):
    READ_FRAME_MAGIC = 1
    READ_FRAME_HEADER = 2
    READ_BLOCK_HEADER = 3
    READ_BLOCK = 4
    READ_BLOCK_CHECKSUM = 5


class ZstdIncrementalFrameDecompressor:
    """Feed arbitrary input slices, pull decoded bytes.

    ``partial_decompress(data)`` consumes what it can (stashing any
    unconsumed tail) and returns newly decoded output. ``input_required``
    reports the minimum additional bytes needed to make progress.
    """

    def __init__(self):
        self._state = _State.READ_FRAME_MAGIC
        self._pending = b""
        # sliding window of decoded frame content
        self._win = np.zeros(0, dtype=np.uint8)
        self._len = 0  # decoded bytes currently in _win
        self._dropped = 0  # window bytes discarded from the front
        self._flushed = 0  # _win index already returned to the caller
        self._has_checksum = False
        self._hash = None
        self._block_header = None
        self._ctx = None
        self._window_size = 0
        self.input_required = 4

    def finished(self) -> bool:
        return self._state is _State.READ_FRAME_MAGIC and not self._pending

    def _ensure_capacity(self, extra: int) -> None:
        need = self._len + extra
        if self._win.size < need:
            cap = max(need, 2 * self._win.size, 256 * 1024)
            grown = np.zeros(cap, dtype=np.uint8)
            grown[: self._len] = self._win[: self._len]
            self._win = grown

    def _flush_excess(self, produced: bytearray) -> None:
        """Emit decoded bytes no longer needed as match history; compact."""
        keep = max(self._window_size, 0)
        flush_to = self._len - keep
        if flush_to > self._flushed:
            produced += self._win[self._flushed : flush_to].tobytes()
            self._flushed = flush_to
        if self._flushed > max(keep * 2, 256 * 1024):
            drop = self._flushed
            self._win[: self._len - drop] = self._win[drop : self._len]
            self._len -= drop
            self._dropped += drop
            self._flushed = 0

    def partial_decompress(self, data: bytes) -> bytes:
        buf = self._pending + bytes(data)
        self._pending = b""
        pos = 0
        produced = bytearray()

        def avail() -> int:
            return len(buf) - pos

        while True:
            if self._state is _State.READ_FRAME_MAGIC:
                if avail() < 4:
                    self.input_required = 4 - avail()
                    break
                magic = int.from_bytes(buf[pos : pos + 4], "little")
                if (magic & C.MAGIC_SKIPPABLE_MASK) == C.MAGIC_SKIPPABLE_BASE:
                    if avail() < 8:
                        self.input_required = 8 - avail()
                        break
                    skip = int.from_bytes(buf[pos + 4 : pos + 8], "little")
                    if avail() < 8 + skip:
                        self.input_required = 8 + skip - avail()
                        break
                    pos += 8 + skip
                    continue
                if magic != C.MAGIC:
                    raise MalformedInputException(pos, "invalid zstd magic")
                pos += 4
                self._state = _State.READ_FRAME_HEADER
            elif self._state is _State.READ_FRAME_HEADER:
                if avail() < 1:
                    self.input_required = 1
                    break
                try:
                    src = np.frombuffer(
                        buf, dtype=np.uint8, count=min(avail(), 14), offset=pos
                    )
                    hdr = frame_dec.read_frame_header(src, 0)
                except MalformedInputException:
                    if avail() < 14:
                        self.input_required = 14 - avail()
                        break
                    raise
                if hdr.dictionary_id:
                    raise MalformedInputException(pos, "dictionaries are not supported")
                if not hdr.single_segment and hdr.window_size > C.MAX_WINDOW_SIZE:
                    raise MalformedInputException(pos, "window size too large")
                pos += hdr.header_size
                self._has_checksum = hdr.has_checksum
                self._hash = xxh.XxHash64State() if hdr.has_checksum else None
                self._window_size = (
                    hdr.window_size
                    if 0 <= hdr.window_size <= C.MAX_WINDOW_SIZE
                    else C.MAX_WINDOW_SIZE
                )
                self._ctx = frame_dec.new_frame_context()
                self._len = self._dropped = self._flushed = 0
                self._state = _State.READ_BLOCK_HEADER
            elif self._state is _State.READ_BLOCK_HEADER:
                if avail() < 3:
                    self.input_required = 3 - avail()
                    break
                v = buf[pos] | (buf[pos + 1] << 8) | (buf[pos + 2] << 16)
                pos += 3
                self._block_header = (v & 1, (v >> 1) & 3, v >> 3)
                self._state = _State.READ_BLOCK
            elif self._state is _State.READ_BLOCK:
                last, btype, bsize = self._block_header
                in_size = 1 if btype == C.RLE_BLOCK else bsize
                if avail() < in_size:
                    self.input_required = in_size - avail()
                    break
                # a zero-size block (content ending exactly on a block
                # boundary emits an empty RAW last block) must not read:
                # pos may sit exactly at the buffer end here
                payload = (np.frombuffer(buf, dtype=np.uint8, count=in_size,
                                         offset=pos)
                           if in_size else np.zeros(0, np.uint8))
                self._ensure_capacity(max(bsize, C.MAX_BLOCK_SIZE))
                old_len = self._len
                self._len = frame_dec.decode_block_into(
                    btype, bsize, payload, self._win, old_len,
                    -self._dropped, self._ctx,
                )
                pos += in_size
                if self._hash is not None and self._len > old_len:
                    self._hash.update(self._win[old_len : self._len])
                self._flush_excess(produced)
                self._state = (
                    _State.READ_BLOCK_CHECKSUM if last else _State.READ_BLOCK_HEADER
                )
            elif self._state is _State.READ_BLOCK_CHECKSUM:
                if self._has_checksum:
                    if avail() < 4:
                        self.input_required = 4 - avail()
                        break
                    stored = int.from_bytes(buf[pos : pos + 4], "little")
                    pos += 4
                    if (self._hash.digest() & 0xFFFFFFFF) != stored:
                        raise MalformedInputException(pos, "frame checksum mismatch")
                produced += self._win[self._flushed : self._len].tobytes()
                self._len = self._dropped = self._flushed = 0
                self._ctx = None
                self._state = _State.READ_FRAME_MAGIC
                self.input_required = 4
            else:  # pragma: no cover
                raise AssertionError(self._state)
        self._pending = bytes(buf[pos:])
        return bytes(produced)

    # ---- caller-buffer contract (parity: reference
    # ZstdIncrementalFrameDecompressor.java:79-97 — getInputRequired /
    # getInputConsumed / getOutputBufferUsed / getRequestedOutputSize /
    # isAtStoppingPoint)

    _backlog: bytes = b""
    input_consumed: int = 0
    output_buffer_used: int = 0

    @property
    def requested_output_size(self) -> int:
        """Output space the next call wants: the internal backlog if any,
        else a block-sized default (the reference requests the current
        block's regenerated size; one MAX_BLOCK covers any block)."""
        return len(self._backlog) if self._backlog else C.MAX_BLOCK_SIZE

    def is_at_stopping_point(self) -> bool:
        """True between frames with nothing buffered — the caller may stop
        feeding input here without losing data."""
        return (self._state is _State.READ_FRAME_MAGIC
                and not self._pending and not self._backlog)

    def partial_decompress_into(self, data: bytes, out, out_off: int,
                                out_limit: int) -> None:
        """Decompress into the CALLER's buffer slice ``out[out_off:out_limit]``.

        Consumes input only while output space remains (when the buffer
        fills, remaining decoded bytes are held in an internal backlog and
        ``input_consumed`` reports 0 for subsequent calls until drained).
        After the call: ``input_consumed`` = bytes of ``data`` accepted,
        ``output_buffer_used`` = bytes written at ``out_off``,
        ``input_required`` / ``requested_output_size`` describe the next
        call's needs.
        """
        if out_limit > len(out):
            raise ValueError("output limit beyond buffer")
        space = out_limit - out_off
        written = 0
        if self._backlog:
            take = min(space, len(self._backlog))
            out[out_off : out_off + take] = self._backlog[:take]
            self._backlog = self._backlog[take:]
            written = take
            space -= take
        if self._backlog or space == 0:
            # output-blocked: refuse the input so the caller re-presents it
            self.input_consumed = 0
            self.output_buffer_used = written
            return
        produced = self.partial_decompress(data)
        self.input_consumed = len(data)
        take = min(space, len(produced))
        out[out_off + written : out_off + written + take] = produced[:take]
        self._backlog = produced[take:]
        self.output_buffer_used = written + take


class ZstdInputStream(io.RawIOBase):
    """Streaming reader (reference: zstd/ZstdInputStream.java)."""

    def __init__(self, source, read_chunk: int = 128 * 1024):
        self._source = source
        self._chunk = read_chunk
        self._dec = ZstdIncrementalFrameDecompressor()
        self._buf = b""
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> None:
        while not self._buf and not self._eof:
            raw = self._source.read(self._chunk)
            if not raw:
                if not self._dec.finished():
                    raise MalformedInputException(0, "truncated zstd stream")
                self._eof = True
                return
            self._buf = self._dec.partial_decompress(raw)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while True:
                self._fill()
                if not self._buf:
                    return b"".join(chunks)
                chunks.append(self._buf)
                self._buf = b""
        self._fill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


class ZstdOutputStream(io.RawIOBase):
    """TRUE streaming writer: ONE frame per stream, unknown content size,
    with the match window carried across write() calls (reference:
    zstd/ZstdOutputStream.java:154-221 + BlockCompressionState.slideWindow).

    Each full 128KB block compresses against up to (window - blockSize)
    bytes of retained history, so cross-chunk matches survive chunked
    writes; repcodes and the xxhash64 content checksum persist across
    blocks and a single checksum closes the frame."""

    def __init__(self, sink, level: int = 3):
        self._sink = sink
        self._level = level
        self._params = _params(level, None)
        # window from the level table (cap 23 = the decoder-side maximum);
        # history below blockSize would allow no cross-block matches
        wlog = max(18, min(self._params.window_log, 23))
        self._window = 1 << wlog
        self._ctx = self._window - C.MAX_BLOCK_SIZE
        self._hist = b""
        self._pending = bytearray()
        self._rep = list(C.REP_INIT)
        self._ectx = frame_enc.EncoderContext()
        self._hash = xxh.XxHash64State()
        self._finished = False
        self._wrote_header = False
        self._wlog = wlog

    def writable(self) -> bool:
        return True

    def _write_header(self) -> None:
        out = bytearray()
        out += int(frame_enc.MAGIC).to_bytes(4, "little")
        # FHD: no content size, not single-segment, checksum flag; then the
        # window descriptor (power-of-two: exponent only)
        out.append(0x04)
        out.append((self._wlog - 10) << 3)
        self._sink.write(bytes(out))
        self._wrote_header = True

    def _compress_block(self, block: bytes, last: int) -> None:
        if not self._wrote_header:
            self._write_header()
        joined = self._hist + block
        arr = np.frombuffer(joined, dtype=np.uint8)
        start = len(self._hist)
        ll, offsets, ml, literals = block_enc.find_sequences(
            arr, self._params, start=start)
        blk = arr[start:]
        # _encode_block takes pre-repcode wire values = distance + 3
        # (same bias _partition_blocks applies on the batch path)
        self._sink.write(frame_enc._encode_block(
            last, blk, ll, offsets + 3, ml, literals, self._rep,
            self._ectx))
        self._hash.update(block)
        self._hist = joined[-self._ctx:] if self._ctx else b""

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("stream already finished")
        data = bytes(data)
        self._pending += data
        while len(self._pending) > C.MAX_BLOCK_SIZE:
            # strictly greater: the final full block must become `last`
            # in finish() if nothing follows
            self._compress_block(
                bytes(self._pending[: C.MAX_BLOCK_SIZE]), last=0)
            del self._pending[: C.MAX_BLOCK_SIZE]
        return len(data)

    def finish(self) -> None:
        if self._finished:
            return
        if not self._wrote_header:
            self._write_header()
        self._compress_block(bytes(self._pending), last=1)
        self._pending.clear()
        digest = self._hash.digest()
        self._sink.write(int(digest & 0xFFFFFFFF).to_bytes(4, "little"))
        self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.finish()
            super().close()


def compress_stream(data: bytes, level: int = 3) -> bytes:
    sink = io.BytesIO()
    s = ZstdOutputStream(sink, level)
    s.write(data)
    s.finish()
    return sink.getvalue()


def decompress_stream(data: bytes) -> bytes:
    return ZstdInputStream(io.BytesIO(data)).read()
