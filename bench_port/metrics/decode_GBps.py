"""Decoded GB/s: the bytes of every batch the window completed (each chunk
decoded and checksummed, its lengths, ``ok`` and digests read back), over
the window's wall time."""


def read(run):
    if run.direction != "decode":
        return None
    return run.raw_bytes_done / run.window_s / 1e9
