"""The port's error type: the same surface as ``aircompressor_tpu.errors``."""

from __future__ import annotations


class MalformedInputException(ValueError):
    """Raised when a compressed stream is invalid or corrupt.

    ``offset`` is the input byte offset, or the index of the chunk in a
    batch, at which the malformation was found; ``reason`` says what it was.
    """

    def __init__(self, offset: int, reason: str = "Malformed input"):
        self.offset = int(offset)
        self.reason = reason
        super().__init__(f"{reason}: offset={offset}")


class IncompatiblePlatformException(RuntimeError):
    """Raised when a backend tier cannot run on the current platform (the
    JAX package's counterpart of the same name; the reference's
    IncompatibleJvmException)."""
