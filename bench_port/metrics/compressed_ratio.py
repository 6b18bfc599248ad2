"""Compressed bytes over input bytes, summed over the window's batches."""


def read(run):
    if run.direction != "encode" or not run.raw_bytes_done:
        return None
    return run.out_bytes_done / run.raw_bytes_done
