"""The share of its roofline of the Snappy encode kernel
(``csrc/snappy_encode.cu``): the least time of one launch (its bytes at the
memory rate, ``roofline.kernel_bytes(run, "encode")``) over its mean device
time in the trace."""

from bench_port import roofline

KERNEL = r"\bsnappy_encode_kernel\b"


def read(run):
    if run.direction != "encode":
        return None
    return roofline.share_pct(run, "encode", KERNEL)
