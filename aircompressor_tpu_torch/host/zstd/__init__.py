"""The port's numpy copies of the JAX package's zstd host code.

- ``constants``, ``bits``, ``fse``, ``huffman``: table readers, bit readers
  and the Huffman stream decoders of the host frame decoder;
- ``device_prep``: the planner that parses frame, block and table headers
  and describes each entropy stream for the decode kernels; its header and
  table readers are also those of the host frame decoder
  (``zstd.frame_dec``, outside this package, with the zstd family);
- ``params``, ``fse_enc``, ``huff_enc``, ``seq_enc``, ``block_enc``,
  ``frame_enc``: the host encoder (``frame_enc.compress_bytes``), which
  makes the frames of the checks where no other zstd encoder is installed
  and the frames of chunks the batched compress does not plan;
- ``device_enc``: the host half of batched compress (``ops/zstd_encode``):
  the proposal check, the per-chunk plan, the emission kernel's packed
  arrays and frame assembly.

Imports are rewritten to the port's own modules; behaviour is unchanged.
"""
