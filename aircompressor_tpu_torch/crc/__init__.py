"""CRC32-C family: the port's counterpart of ``aircompressor_tpu.crc``, over
``host/crc32c.py`` (numpy, as the JAX family is). The batched CRC on the
card is ``ops.checksum.crc32c``."""

from ..host.crc32c import Crc32C, crc32c_raw, mask_crc, masked_crc32c

__all__ = ["Crc32C", "crc32c_raw", "mask_crc", "masked_crc32c"]
