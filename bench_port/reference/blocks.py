"""Plain scalar Snappy and LZ4 block decoders, written from the public
format descriptions (google/snappy ``format_description.txt``; lz4
``doc/lz4_Block_format.md``), one byte string at a time.

Each returns the decoded bytes, or raises ``ValueError`` on a block that
breaks its format: a parse past the end, an offset of 0 or before the
output, more output than the cap, a Snappy block whose output differs from
its declared length, an LZ4 block that does not end on a literal run.
``window`` makes the control decoder: a copy from farther back than
``window`` bytes reads zeros instead, the step that a decoder which keeps
only a recent window and skips device memory would take.
"""

from __future__ import annotations


def _copy(out: bytearray, offset: int, length: int, window: int | None) -> None:
    if offset == 0 or offset > len(out):
        raise ValueError(f"offset {offset} with {len(out)} bytes out")
    if window is not None and offset > window:
        out += bytes(length)
        return
    start = len(out) - offset
    if offset >= length:
        out += out[start:start + length]
    else:
        pattern = out[start:]
        out += (pattern * (length // offset + 1))[:length]


def snappy_decode(block: bytes, cap: int = 65536, window: int | None = None) -> bytes:
    """Decode one Snappy block of at most ``cap`` output bytes."""
    n = len(block)
    declared, shift, ip = 0, 0, 0
    while True:
        if ip >= n or shift > 28:
            raise ValueError("bad length varint")
        b = block[ip]
        ip += 1
        declared |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    if declared > cap:
        raise ValueError(f"declared length {declared} over {cap}")
    out = bytearray()
    while ip < n:
        tag = block[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if ip + extra > n:
                    raise ValueError("literal length past the end")
                length = int.from_bytes(block[ip:ip + extra], "little") + 1
                ip += extra
            if ip + length > n:
                raise ValueError("literal past the end")
            out += block[ip:ip + length]
            ip += length
        else:
            if kind == 1:
                if ip + 1 > n:
                    raise ValueError("copy past the end")
                length = 4 + ((tag >> 2) & 7)
                offset = ((tag >> 5) << 8) | block[ip]
                ip += 1
            else:
                width = 2 if kind == 2 else 4
                if ip + width > n:
                    raise ValueError("copy past the end")
                length = (tag >> 2) + 1
                offset = int.from_bytes(block[ip:ip + width], "little")
                ip += width
            _copy(out, offset, length, window)
        if len(out) > declared:
            raise ValueError("output past the declared length")
    if len(out) != declared:
        raise ValueError(f"{len(out)} bytes out, {declared} declared")
    return bytes(out)


def lz4_decode(block: bytes, cap: int = 65536, window: int | None = None) -> bytes:
    """Decode one LZ4 block of at most ``cap`` output bytes."""
    n = len(block)
    if n == 0:
        raise ValueError("empty block")
    out = bytearray()
    ip = 0
    while True:
        if ip >= n:
            raise ValueError("block ends inside a sequence")
        token = block[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ValueError("literal length past the end")
                b = block[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n:
            raise ValueError("literals past the end")
        out += block[ip:ip + lit]
        ip += lit
        if len(out) > cap:
            raise ValueError(f"output over {cap}")
        if ip == n:
            return bytes(out)
        if ip + 2 > n:
            raise ValueError("offset past the end")
        offset = block[ip] | (block[ip + 1] << 8)
        ip += 2
        length = token & 15
        if length == 15:
            while True:
                if ip >= n:
                    raise ValueError("match length past the end")
                b = block[ip]
                ip += 1
                length += b
                if b != 255:
                    break
        _copy(out, offset, length + 4, window)
        if len(out) > cap:
            raise ValueError(f"output over {cap}")
