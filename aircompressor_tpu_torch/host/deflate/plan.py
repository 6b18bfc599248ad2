"""Host planning for the card's raw-deflate decode.

The port's counterpart of ``aircompressor_tpu.deflate.device_prep``'s
``plan_batch`` and ``pack_pages``. The C++ planner (``inflate_plan.cc``,
built with g++ by ``_build.build_host``) walks each chunk's blocks, builds
its two-level Huffman tables (9-bit root) and validates the stream; the
kernel (``csrc/deflate_decode.cu``) then decodes every symbol from the
bitstream with those tables.

Per chunk the planner gives descriptors of 8 int32 fields a block: type (0
stored, 1 Huffman), the bit position of its data, the literal/length and
distance root bases, the stored block's byte offset and length, the final
flag, and a field left 0. Table entries are ``(op << 28) | (nbits << 22) |
val`` with op 0 invalid, 1 literal, 2 length, 3 distance, 4 end of block, 5
subtable. Where a chunk fits the JAX planner's caps (16 blocks, 12288
entries with its 128-entry descriptor row), its blocks and entries are the
JAX planner's, with every table index 128 lower.

There is no host route: ``plan`` plans every chunk at the default caps,
plans again at caps that fit each chunk that reported it needed more room,
and packs the batch flat for the kernel (descriptors and tables of all
chunks one after another, with each chunk's offsets in ``index``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_BLOCKS = 16  # the default caps: the JAX planner's page
TAB_CAP = 96 * 128 - 128
OUT_CAP = 65536
DESC_FIELDS = 8

ST_OK, ST_ROOM, ST_MALFORMED, ST_TOO_LONG = 0, 1, 2, 3


def plan_batch(buf: np.ndarray, lens: np.ndarray, max_blocks: int = MAX_BLOCKS,
               tab_cap: int = TAB_CAP, out_cap: int = OUT_CAP):
    """Plan a (B, cap) uint8 batch of raw-deflate chunks at these caps.

    Returns (desc (B, max_blocks, 8) int32, tabs (B, tab_cap) int32, info
    (B, 4) int32), info rows being [out_len, nblocks, tab_used, status].
    A chunk of status ST_ROOM needs more than the caps, nblocks blocks and
    tab_used entries; only ST_OK chunks have descriptors and tables.
    """
    from ... import _build

    lib = _build.load_host()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if buf.ndim != 2:
        raise ValueError(f"need a (B, cap) uint8 batch, got {buf.shape}")
    B, cap = buf.shape
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    if lens.shape != (B,) or (B and (lens.min() < 0 or lens.max() > cap)):
        raise ValueError(f"need (B,) lengths in [0, {cap}]")
    desc = np.zeros((B, max_blocks, DESC_FIELDS), np.int32)
    tabs = np.zeros((B, tab_cap), np.int32)
    info = np.zeros((B, 4), np.int32)
    lib.acx_inflate_plan_batch(buf.ctypes.data, B, cap, lens.ctypes.data,
                               max_blocks, tab_cap, out_cap, desc.ctypes.data,
                               tabs.ctypes.data, info.ctypes.data)
    return desc, tabs, info


class Plan(NamedTuple):
    """A batch's plan laid out for the kernel: ``desc`` (NB, 8) int32, the
    descriptors of every chunk one after another; ``tabs`` (NT,) int32, the
    tables likewise; ``index`` (B, 4) int32 rows [first descriptor, blocks,
    first table entry, entries], all 0 for a chunk not ST_OK; ``info`` (B,
    4) int32, the planner's [out_len, nblocks, tab_used, status]."""

    desc: np.ndarray
    tabs: np.ndarray
    index: np.ndarray
    info: np.ndarray


def pack(parts, B: int) -> Plan:
    """Lay out planner results flat: ``parts`` holds (rows, desc, tabs,
    info) for disjoint sets of the batch's B rows, as ``plan_batch`` gives
    them for ``buf[rows]``."""
    info = np.zeros((B, 4), np.int32)
    for rows, _, _, inf in parts:
        info[rows] = inf
    ok = info[:, 3] == ST_OK
    nb = np.where(ok, info[:, 1], 0).astype(np.int64)
    nt = np.where(ok, info[:, 2], 0).astype(np.int64)
    index = np.zeros((B, 4), np.int64)
    index[:, 0] = np.cumsum(nb) - nb
    index[:, 1] = nb
    index[:, 2] = np.cumsum(nt) - nt
    index[:, 3] = nt
    index[~ok] = 0
    flat_desc = np.zeros((int(nb.sum()), DESC_FIELDS), np.int32)
    flat_tabs = np.zeros(int(nt.sum()), np.int32)
    for rows, desc, tabs, _ in parts:
        rows = np.asarray(rows)
        k = np.arange(desc.shape[1])[None, :]
        keep = k < nb[rows][:, None]
        flat_desc[(index[rows, 0][:, None] + k)[keep]] = desc[keep]
        k = np.arange(tabs.shape[1])[None, :]
        keep = k < nt[rows][:, None]
        flat_tabs[(index[rows, 2][:, None] + k)[keep]] = tabs[keep]
    if index.size and index.max() >= 2**31:
        raise ValueError("the plan exceeds 2^31 entries")
    return Plan(flat_desc, flat_tabs, index.astype(np.int32), info)


def plan(buf: np.ndarray, lens: np.ndarray, out_cap: int = OUT_CAP) -> Plan:
    """Plan every chunk of a (B, cap) batch for the kernel: at the default
    caps, then each chunk that needs more room again, alone, at caps that
    fit it; then ``pack``. Malformed chunks and chunks whose output passes
    ``out_cap`` keep their status in ``info`` and get no blocks."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    B = buf.shape[0]
    lens = np.asarray(lens)
    desc, tabs, info = plan_batch(buf, lens, out_cap=out_cap)
    fits = info[:, 3] != ST_ROOM
    parts = [(np.nonzero(fits)[0], desc[fits], tabs[fits], info[fits])]
    for i in np.nonzero(~fits)[0]:
        parts.append(([i], *plan_batch(buf[i:i + 1], lens[i:i + 1],
                                       max_blocks=int(info[i, 1]),
                                       tab_cap=int(info[i, 2]), out_cap=out_cap)))
    return pack(parts, B)


__all__ = ["plan_batch", "pack", "plan", "Plan", "MAX_BLOCKS", "TAB_CAP", "OUT_CAP",
           "ST_OK", "ST_ROOM", "ST_MALFORMED", "ST_TOO_LONG"]
