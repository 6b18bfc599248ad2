"""Write ``libdeflate_streams.npz``: raw-deflate streams made by libdeflate,
the fixture that brings libdeflate's output to the deflate decode kernel on
a machine without the library.

Run from the root of a checkout on a machine whose system libdeflate
``ctypes.util.find_library`` finds:

    python3 -m aircompressor_tpu_torch.data.make_libdeflate_streams

Each stream compresses ``_selfcheck_payload(seed)[:cut]`` with
``deflate.DeflateNativeCompressor(level)``. The file holds the streams,
concatenated, with their lengths and the seeds, cuts and levels of their
originals, and the library's file name; the originals are made anew from
their seeds.
"""

from __future__ import annotations

import ctypes.util
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "libdeflate_streams.npz"

# (seed, cut, level): whole 64 KB text chunks at the fast, default and
# near-optimal levels (two or three blocks each), a stored stream, short ones
STREAMS = [
    (0, 65536, 1),
    (0, 65536, 4),
    (0, 65536, 12),
    (33, 65536, 12),
    (96, 16384, 1),
    (96, 16384, 6),
    (96, 16384, 9),
    (5, 4096, 0),
    (5, 4096, 12),
]


def main() -> None:
    from aircompressor_tpu_torch.deflate import DeflateNativeCompressor
    from aircompressor_tpu_torch.ops.batch import _selfcheck_payload

    streams = [DeflateNativeCompressor(level).compress(_selfcheck_payload(seed)[:cut])
               for seed, cut, level in STREAMS]
    spec = np.array(STREAMS, np.int64)
    library = ctypes.util.find_library("deflate")
    np.savez_compressed(
        OUT, streams=np.frombuffer(b"".join(streams), np.uint8),
        lengths=np.array([len(s) for s in streams], np.int64),
        seed=spec[:, 0], cut=spec[:, 1], level=spec[:, 2], library=np.array(library))
    print(f"{OUT.name}: {len(streams)} streams, {sum(map(len, streams))} B, {library}")


if __name__ == "__main__":
    main()
