"""The comparison that decides ``correct``: what the window's batches read
back, and the rows the window's last batches left on the device, against
the benchmark's own inputs and the plain references.

Every number compared is a count of rows, and each is held to the limit 0:
the codecs are lossless and the digests exact.

- ``digest_mismatch_rows``: rows of every batch whose digest differs from
  the reference's over the input chunk (a scan hashes the decoded rows, so
  a wrong decoded byte anywhere shows here).
- ``length_mismatch_rows``: rows of every batch whose decoded length is not
  the chunk's (scan), or whose block length is not in [1, row width]
  (write).
- ``not_ok_rows``: rows of every batch that the port flagged as failed.
- ``byte_mismatch_rows`` (scan): rows of the last batch of each variant
  whose decoded bytes differ from the input chunk, every row compared.
- ``block_mismatch_rows`` (write): rows of the last batch of each variant
  whose block the reference decoder rejects or decodes to other bytes than
  the input chunk, every row decoded (``native.decompress``, the C++
  transcription of ``reference/blocks.py``).
"""

from __future__ import annotations

import numpy as np

from bench_port import native

COMPARE_ROWS = 256  # rows copied back to the host at a time


def _digests(values: np.ndarray) -> np.ndarray:
    """The port's int64 digests as their unsigned bit patterns."""
    return np.ascontiguousarray(values, np.int64).view(np.uint64)


def compare(setup, records, last):
    """``(checks, failed_rows)``: each number compared with its limit, and
    the rows that failed any comparison. ``records`` are the batches' read
    backs ``(variant, lens, ok, digests)``; ``last`` maps a variant to the
    ``(rows, lens)`` tensors of its last batch."""
    chunks, perms, C = setup.chunks, setup.perms, setup.chunk_bytes
    ref = setup.adapter.reference_digest(setup.direction, chunks,
                                         np.full(len(chunks), C)).astype(np.uint64)
    digest = length = not_ok = failed = 0
    for v, lens, ok, dig in records:
        bad_digest = _digests(dig) != ref[perms[v]]
        if setup.direction == "decode":
            bad_len = lens != C
        else:
            bad_len = (lens < 1) | (lens > setup.block_width)
        digest += int(bad_digest.sum())
        length += int(bad_len.sum())
        not_ok += int((~ok).sum())
        failed += int((bad_digest | bad_len | ~ok).sum())
    checks = {"digest_mismatch_rows": digest, "length_mismatch_rows": length,
              "not_ok_rows": not_ok}
    if setup.direction == "decode":
        wrong = _byte_mismatch(chunks, perms, last)
        checks["byte_mismatch_rows"] = wrong
    else:
        wrong = _block_mismatch(setup, last)
        checks["block_mismatch_rows"] = wrong
    return {k: (v, 0) for k, v in checks.items()}, failed + wrong


def _byte_mismatch(chunks, perms, last) -> int:
    wrong = 0
    for v, (rows, _) in last.items():
        for i in range(0, rows.shape[0], COMPARE_ROWS):
            got = rows[i:i + COMPARE_ROWS].cpu().numpy()
            want = chunks[perms[v][i:i + COMPARE_ROWS]]
            if got.shape[1] != want.shape[1]:
                wrong += len(got)
                continue
            wrong += int((got != want).any(1).sum())
    return wrong


def _block_mismatch(setup, last) -> int:
    C, wrong = setup.chunk_bytes, 0
    for v, (rows, lens) in last.items():
        for i in range(0, rows.shape[0], COMPARE_ROWS):
            blocks = rows[i:i + COMPARE_ROWS].cpu().numpy()
            n = lens[i:i + COMPARE_ROWS].cpu().numpy().astype(np.int64)
            fits = (n >= 0) & (n <= blocks.shape[1])
            out, out_lens = native.decompress(setup.adapter.COMPRESSOR, blocks,
                                              np.where(fits, n, 0), C)
            want = setup.chunks[setup.perms[v][i:i + COMPARE_ROWS]]
            wrong += int((~fits | (out_lens != C) | (out != want).any(1)).sum())
    return wrong
