"""The share of its roofline of the LZ4 decode kernel (``csrc/lz4_decode.cu``):
the least time of one launch (its bytes at the memory rate,
``roofline.kernel_bytes(run, "decode")``) over its mean device time in the
trace."""

from bench_port import roofline

KERNEL = r"\blz4_decode_kernel\b"


def read(run):
    if run.direction != "decode":
        return None
    return roofline.share_pct(run, "decode", KERNEL)
