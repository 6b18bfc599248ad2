"""Write ``libzstd_frames.npz``: zstd frames made by libzstd, the fixture of
the zstd decode checks.

Run from the root of a checkout where the ``zstandard`` package (libzstd's
Python binding) is installed:

    python3 -m aircompressor_tpu_torch.data.make_libzstd_frames

Each frame compresses ``_selfcheck_payload(seed)[:cut]`` at a level, with or
without a checksum, and where ``flush`` is not 0 ends a block every
``flush`` bytes (``COMPRESSOBJ_FLUSH_BLOCK``), so that the frame has many
blocks whose sequences use the repeat offsets of the blocks before them.
The file holds the frames, concatenated, with their lengths and the seeds,
cuts, levels, checksum flags and flush intervals of their originals, and
the ``zstandard`` version; the originals are made anew from their seeds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "libzstd_frames.npz"

# (seed, cut, level, checksum, flush)
FRAMES = [
    (3, 8192, 3, True, 1024),
    (3, 8192, 1, False, 0),
    (5, 8192, 19, True, 2048),
    (7, 6000, 3, False, 1536),
    (0xA1C0, 4096, 1, True, 1024),
    (2, 200, 19, True, 0),
    (1, 700, 3, False, 0),
    (11, 16384, 19, True, 1024),
    (13, 16384, 3, False, 2048),
]


def compress(data: bytes, level: int, checksum: bool, flush: int) -> bytes:
    import zstandard

    params = zstandard.ZstdCompressionParameters.from_level(
        level, write_checksum=checksum, write_content_size=True)
    cobj = zstandard.ZstdCompressor(compression_params=params).compressobj(
        size=len(data))
    out = b""
    step = flush or len(data) or 1
    for pos in range(0, len(data), step):
        out += cobj.compress(data[pos:pos + step])
        if flush:
            out += cobj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
    return out + cobj.flush()


def main() -> None:
    import zstandard

    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    frames = [compress(_selfcheck_payload(seed)[:cut], level, checksum, flush)
              for seed, cut, level, checksum, flush in FRAMES]
    spec = np.array(FRAMES, np.int64)
    np.savez_compressed(
        OUT, frames=np.frombuffer(b"".join(frames), np.uint8),
        lengths=np.array([len(f) for f in frames], np.int64),
        seed=spec[:, 0], cut=spec[:, 1], level=spec[:, 2], checksum=spec[:, 3],
        flush=spec[:, 4], zstandard_version=np.array(zstandard.__version__))
    print(f"{OUT.name}: {len(frames)} frames, {sum(map(len, frames))} B, "
          f"zstandard {zstandard.__version__}")


if __name__ == "__main__":
    main()
