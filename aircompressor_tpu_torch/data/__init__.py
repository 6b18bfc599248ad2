"""Fixtures of the port's checks, read with numpy.

``libzstd_frames.npz`` holds zstd frames made by libzstd (written by
``make_libzstd_frames``): multi-block frames whose sequences use the repeat
offsets of earlier blocks, treeless literals, raw blocks and literals, and
single-stream literals, at levels 1, 3 and 19, with and without checksums.
``libdeflate_streams.npz`` holds raw-deflate streams made by libdeflate
(written by ``make_libdeflate_streams``) at levels 0-12, for the deflate
decode kernel on a machine without libdeflate.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

LIBZSTD_FRAMES = Path(__file__).resolve().parent / "libzstd_frames.npz"
LIBDEFLATE_STREAMS = Path(__file__).resolve().parent / "libdeflate_streams.npz"


def libzstd_frames() -> list[dict]:
    """The fixture's frames, each a dict of ``frame`` and ``original``
    (bytes) and the ``seed``, ``cut``, ``level``, ``checksum`` and ``flush``
    it was made with."""
    from ..ops.batch import _selfcheck_payload

    with np.load(LIBZSTD_FRAMES) as z:
        frames = np.split(z["frames"], np.cumsum(z["lengths"])[:-1])
        spec = zip(*(z[k].tolist() for k in ("seed", "cut", "level", "checksum", "flush")))
        return [dict(frame=f.tobytes(), original=_selfcheck_payload(seed)[:cut],
                     seed=seed, cut=cut, level=level, checksum=bool(checksum),
                     flush=flush)
                for f, (seed, cut, level, checksum, flush) in zip(frames, spec)]


def zstandard_version() -> str:
    """The version of the ``zstandard`` package that made the frames."""
    with np.load(LIBZSTD_FRAMES) as z:
        return str(z["zstandard_version"])


def libdeflate_streams() -> list[dict]:
    """The fixture's streams, each a dict of ``stream`` and ``original``
    (bytes) and the ``seed``, ``cut`` and ``level`` it was made with."""
    from ..ops.batch import _selfcheck_payload

    with np.load(LIBDEFLATE_STREAMS) as z:
        streams = np.split(z["streams"], np.cumsum(z["lengths"])[:-1])
        spec = zip(*(z[k].tolist() for k in ("seed", "cut", "level")))
        return [dict(stream=s.tobytes(), original=_selfcheck_payload(seed)[:cut],
                     seed=seed, cut=cut, level=level)
                for s, (seed, cut, level) in zip(streams, spec)]


def libdeflate_library() -> str:
    """The file name of the libdeflate that made the streams."""
    with np.load(LIBDEFLATE_STREAMS) as z:
        return str(z["library"])
