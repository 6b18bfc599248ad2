"""The least time a batch's kernels could take on one H100: the bytes each
needs, read once and written once, at the card's memory rate. None of these
kernels does floating-point work, so memory bounds them all.

The bytes come from the benchmark's inputs (chunk lengths, and the frozen
compressor's block lengths), never from the port's outputs, so the count
reads the same work whatever implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s, at the full 700 W.
HBM_BYTES_PER_S = 3.35e12

LENGTH_BYTES = 4  # int32 lengths, read or written once a row
OK_BYTES = 1  # bool flag a row


def decode_bytes(comp_bytes: int, rows: int, out_cap: int) -> int:
    """A batched decode: the compressed bytes and the lengths read once;
    every output row written once to ``out_cap`` (the op's contract
    zero-fills the tail), and the lengths and ``ok`` written once."""
    return comp_bytes + LENGTH_BYTES * rows + rows * out_cap + (LENGTH_BYTES + OK_BYTES) * rows


def hash_bytes(row_bytes: int, rows: int, digest_bytes: int) -> int:
    """A batched checksum: the rows hashed read once, the lengths read, the
    digests written."""
    return row_bytes + LENGTH_BYTES * rows + digest_bytes * rows


def encode_bytes(in_bytes: int, ref_comp_bytes: int, rows: int) -> int:
    """A batched encode: the input and lengths read once; the output counted
    as the frozen reference compressor's blocks for the same chunks, with
    the lengths and ``ok`` written once."""
    return in_bytes + LENGTH_BYTES * rows + ref_comp_bytes + (LENGTH_BYTES + OK_BYTES) * rows


def seconds(n_bytes: int) -> float:
    """The least time to move ``n_bytes`` at the memory rate."""
    return n_bytes / HBM_BYTES_PER_S


def kernel_bytes(run, kernel: str) -> int:
    """The bytes one launch of the cell's ``kernel`` needs: ``"decode"``,
    ``"encode"`` or ``"hash"``, by the run's batch geometry."""
    b = run.batch
    if kernel == "decode":
        return decode_bytes(b.comp_bytes, b.rows, b.chunk_bytes)
    if kernel == "encode":
        return encode_bytes(b.raw_bytes, b.comp_bytes, b.rows)
    if kernel == "hash":
        return hash_bytes(b.raw_bytes, b.rows, b.digest_bytes)
    raise ValueError(f"no byte count for {kernel!r}")


def share_pct(run, kernel: str, pattern: str) -> float | None:
    """100 × the least time of one launch over the mean device time of the
    trace's kernels whose name matches ``pattern``; None where the trace
    holds none."""
    if run.trace is None:
        return None
    mean_s = run.trace.kernel_mean_s(pattern)
    if mean_s is None:
        return None
    return 100.0 * seconds(kernel_bytes(run, kernel)) / mean_s
