"""The share of its roofline of the LZ4 encode kernel (``csrc/lz4_encode.cu``):
the least time of one launch (its bytes at the memory rate,
``roofline.kernel_bytes(run, "encode")``) over its mean device time in the
trace."""

from bench_port import roofline

KERNEL = r"\blz4_encode_kernel\b"


def read(run):
    if run.direction != "encode":
        return None
    return roofline.share_pct(run, "encode", KERNEL)
