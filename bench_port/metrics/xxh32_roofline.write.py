"""The share of its roofline of the XXH32 kernel (``csrc/xxh32.cu``) over the
input rows: the least time of one launch (its bytes at the memory rate,
``roofline.kernel_bytes(run, "hash")``) over its mean device time in the
trace."""

from bench_port import roofline

KERNEL = r"\bxxh32_kernel\b"


def read(run):
    if run.direction != "encode":
        return None
    return roofline.share_pct(run, "hash", KERNEL)
