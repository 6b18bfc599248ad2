"""Batched zstd compress: the emission kernel, its plain PyTorch version, and
``compress_batch``, the counterpart of
``aircompressor_tpu.ops.zstd_encode_jax.compress_batch``.

``compress_batch`` runs, for a batch of chunks of at most 64 KB:

1. at level 3, the DFAST matcher kernel over the whole batch
   (``zstd_dfast.find_sequences``); every proposal is checked on the host
   (``_verify_proposals``: structure, coverage and every matched byte); a
   chunk with no sequence takes the host matcher, as in the JAX package;
   at other levels, or with ``device_matcher=False``, every chunk takes the
   host matcher (``block_enc.find_sequences``);
2. the host plan of each chunk (``_plan_chunk``: repeat-offset codes,
   Huffman and FSE tables, mode decisions);
3. the emission kernel once over every chunk whose plan is marked
   ``device`` (``emit``: four Huffman literal streams and the FSE
   sequences stream of its one block), its inputs laid out by
   ``pack_plans``;
4. frame assembly on the host (``_assemble``), with each chunk's checksum
   from the xxh64 kernel over the batch. A chunk whose plan is not marked
   ``device``, or whose block would not gain, is written by
   ``host.zstd.frame_enc.compress_bytes``: raw or RLE literals and raw
   blocks, the format's own choices, as in the JAX package.

The check, the plans, the packing and the assembly run in the C++ planner
(``host/zstd/encode_plan.cc``, built with g++ by ``_build.build_host``), one
call a batch each (``match``, ``plan``, ``emit_plans``, ``assemble``); the
functions named above, in ``host.zstd.device_enc``, stay as its reference,
and ``Plans`` gives the same plans, rows and frames.

With the matcher off, every frame equals ``frame_enc.compress_bytes``'s byte
for byte. Differences from ``zstd_encode_jax.compress_batch``, by design:
a proposal that fails the check, or a chunk the matcher flags not ok,
raises RuntimeError naming the chunk (the JAX function falls back to the
host matcher, which would hide a fault of the kernel; ROADMAP F9); a chunk
over 64 KB raises ValueError; the emission runs once for the batch, not
once for every 32 chunks.

``emit`` launches ``csrc/zstd_emit.cu`` for CUDA tensors (five warps a
block: the Huffman streams packed by warp prefix sums of their code
lengths, the sequences stream by windows of its FSE walk) and uses
``emit_plain`` only for tensors on the CPU. Its inputs are the arrays of
``device_enc.pack_plans``; its outputs those of ``_emit_device``: the
Huffman streams' bytes (B, 4, LSTREAM_CAP) uint8 and bit totals (B, 4)
int32, the sequences stream's bytes (B, SSTREAM_CAP) uint8 and bit total
(B,) int32, zero past each stream's end mark. A stream over its capacity
raises RuntimeError (none is possible for a planned block of 64 KB; the
JAX function would clamp and corrupt it).
"""

from __future__ import annotations

import ctypes
import traceback

import numpy as np
import torch

from .. import _build
from ..host.zstd import block_enc, frame_enc
from ..host.zstd import device_enc as de
from ..host.zstd.params import compute as _params
from . import xxhash, zstd_dfast
from ._rows import MAX_CHUNK

LIT_CAP, SEG_CAP, S_CAP = de.LIT_CAP, de.SEG_CAP, de.S_CAP
LSTREAM_CAP, SSTREAM_CAP = de.LSTREAM_CAP, de.SSTREAM_CAP
NS_CAP, SYM_CAP = de.NS_CAP, de.SYM_CAP

# Kernel launches and the rows they emitted, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0
# compress_batch's routes: the chunks that took the host matcher, and those
# written by the host encoder (frame_enc.compress_bytes).
host_matcher_rows = 0
host_frame_rows = 0

# (name, dtype, shape after the batch dimension) of emit's inputs, the
# arrays of device_enc.pack_plans
EMIT_INPUTS = (("lit", torch.uint8, (LIT_CAP,)), ("lit_seg", torch.int32, (4, 2)),
           ("huff", torch.int32, (2, 256)), ("seq", torch.int32, (9, S_CAP)),
           ("nseq", torch.int32, ()), ("fse_sym", torch.int32, (3, 2, SYM_CAP)),
           ("fse_ns", torch.int32, (3, NS_CAP)), ("flush_bits", torch.int32, (3,)))


def _check_emit_args(args) -> tuple:
    if len(args) != len(EMIT_INPUTS):
        raise TypeError(f"emit takes {len(EMIT_INPUTS)} tensors, got {len(args)}")
    B = args[0].shape[0]
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {devices}")
    for t, (name, dtype, shape) in zip(args, EMIT_INPUTS):
        if t.dtype != dtype or tuple(t.shape) != (B, *shape):
            raise ValueError(f"{name} must be a {dtype} tensor of shape "
                             f"{('B', *shape)}, got {t.dtype} {tuple(t.shape)}")
    return tuple(t.contiguous() for t in args)


def _check_totals(lit_tot: torch.Tensor, seq_tot: torch.Tensor) -> None:
    over = ((lit_tot >= 8 * LSTREAM_CAP).any(1) | (seq_tot >= 8 * SSTREAM_CAP)).cpu()
    if bool(over.any()):
        raise RuntimeError(f"zstd emission overflowed a stream of row "
                           f"{int(over.nonzero()[0, 0])}")


def emit(lit, lit_seg, huff, seq, nseq, fse_sym, fse_ns, flush_bits):
    """Emit the entropy streams of B planned blocks; see the module doc."""
    global launches, rows
    args = _check_emit_args((lit, lit_seg, huff, seq, nseq, fse_sym, fse_ns, flush_bits))
    dev = args[0].device
    if dev.type == "cpu":
        return emit_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no zstd emission for device {dev}")
    lib = _build.load()
    B = args[0].shape[0]
    lit_bytes = torch.empty((B, 4, LSTREAM_CAP), dtype=torch.uint8, device=dev)
    lit_tot = torch.empty((B, 4), dtype=torch.int32, device=dev)
    seq_bytes = torch.empty((B, SSTREAM_CAP), dtype=torch.uint8, device=dev)
    seq_tot = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            err = lib.acx_zstd_emit(
                *(t.data_ptr() for t in args), B, lit_bytes.data_ptr(),
                lit_tot.data_ptr(), seq_bytes.data_ptr(), seq_tot.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"zstd emission kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
        _check_totals(lit_tot, seq_tot)
    return lit_bytes, lit_tot, seq_bytes, seq_tot


def _pack_bits(vals: torch.Tensor, nbits: torch.Tensor, cap: int):
    """(B, N) values and widths, packed least significant bit first with an
    end-mark bit after the last, into (B, cap) uint8; and (B,) bit totals.
    Bits are disjoint, so each byte is the sum of its contributions; those
    at or past ``cap`` land in sink columns."""
    B = vals.shape[0]
    nbits = nbits.clamp(0, 31)
    vals = vals & ((1 << nbits) - 1)
    offs = nbits.cumsum(1) - nbits
    total = nbits.sum(1)
    shifted = vals << (offs & 7)
    byte0 = offs >> 3
    buf = torch.zeros((B, cap + 8), dtype=torch.int64, device=vals.device)
    for k in range(5):  # a value of <= 31 bits at a shift of <= 7 spans 5 bytes
        buf.scatter_add_(1, (byte0 + k).clamp(max=cap + 7), (shifted >> (8 * k)) & 0xFF)
    buf.scatter_add_(1, (total >> 3).clamp(max=cap + 7)[:, None], (1 << (total & 7))[:, None])
    return buf[:, :cap].to(torch.uint8), total.to(torch.int32)


def emit_plain(lit, lit_seg, huff, seq, nseq, fse_sym, fse_ns, flush_bits):
    """Plain PyTorch emission with the kernel's results, for tests and
    checks: ``_emit_device``'s formulation, each stream's ops packed at
    once by prefix sums of their widths, and the three FSE states walked one
    sequence of every row a step."""
    lit, lit_seg, huff, seq, nseq, fse_sym, fse_ns, flush_bits = _check_emit_args(
        (lit, lit_seg, huff, seq, nseq, fse_sym, fse_ns, flush_bits))
    dev = lit.device
    i64 = torch.int64
    B = lit.shape[0]
    huff, seq, fse_sym, fse_ns = huff.to(i64), seq.to(i64), fse_sym.to(i64), fse_ns.to(i64)

    # Huffman streams: the segment's symbols in reverse order.
    j = torch.arange(SEG_CAP, device=dev)[None, :]
    lit_bytes, lit_tot = [], []
    for s in range(4):
        start, cnt = lit_seg[:, s, 0:1].to(i64), lit_seg[:, s, 1:2].to(i64)
        sym = lit.gather(1, (start + cnt - 1 - j).clamp(0, LIT_CAP - 1)).to(i64)
        nb = torch.where(j < cnt, huff[:, 1].gather(1, sym), 0)
        by, tot = _pack_bits(huff[:, 0].gather(1, sym), nb, LSTREAM_CAP)
        lit_bytes.append(by)
        lit_tot.append(tot)

    # Sequences: fields (LL, ML, OF) along dim 1 of codes, extras, extra bits.
    codes, extras, xbits = seq[:, 0:3], seq[:, 3:6], seq[:, 6:9]
    n = nseq.to(i64).clamp(0, S_CAP)
    last = (n - 1).clamp(min=0)
    has = (n > 0)[:, None]
    dnb, dfs = fse_sym[:, :, 0], fse_sym[:, :, 1]  # (B, 3, SYM_CAP)

    def table(codes_at):  # (B, 3, K) codes -> their delta_nb_bits, delta_find_state
        c = codes_at.clamp(0, SYM_CAP - 1)
        return dnb.gather(2, c), dfs.gather(2, c)

    last3 = last[:, None, None].expand(B, 3, 1)
    d0, f0 = table(codes.gather(2, last3))
    nb0 = ((d0 + (1 << 15)) >> 16).clamp(0, 31)
    st = fse_ns.gather(2, ((((nb0 << 16) - d0) >> nb0) + f0).clamp(0, NS_CAP - 1))[:, :, 0]

    steps = int(last.max()) if B else 0
    jj = torch.arange(steps, device=dev)[None, :]
    live = jj < last[:, None]  # (B, steps): step jj writes sequence last - 1 - jj
    rev = (last[:, None] - 1 - jj).clamp(0, S_CAP - 1)[:, None, :].expand(B, 3, steps)
    d, f = table(codes.gather(2, rev))
    st_v = torch.zeros((B, 3, steps), dtype=i64, device=dev)
    st_b = torch.zeros((B, 3, steps), dtype=i64, device=dev)
    for t in range(steps):
        on = live[:, t:t + 1]
        nb = torch.where(on, ((st + d[:, :, t]) >> 16).clamp(0, 31), 0)
        st_v[:, :, t], st_b[:, :, t] = st, nb
        nxt = fse_ns.gather(2, ((st >> nb) + f[:, :, t]).clamp(0, NS_CAP - 1)[:, :, None])
        st = torch.where(on, nxt[:, :, 0], st)

    # Writer order: head [LL, ML, OF extras of the last sequence]; per step
    # [OF, ML, LL states, LL, ML, OF extras]; flush [ML, OF, LL states].
    head_v = extras.gather(2, last3)[:, :, 0]
    head_b = torch.where(has, xbits.gather(2, last3)[:, :, 0], 0)
    flip = [2, 1, 0]
    body_v = torch.cat([st_v[:, flip], extras.gather(2, rev)], 1)
    body_b = torch.cat([st_b[:, flip], torch.where(live[:, None], xbits.gather(2, rev), 0)], 1)
    tail_v = st[:, [1, 2, 0]]
    tail_b = torch.where(has, flush_bits.to(i64), 0)
    vals = torch.cat([head_v, body_v.transpose(1, 2).reshape(B, -1), tail_v], 1)
    bits = torch.cat([head_b, body_b.transpose(1, 2).reshape(B, -1), tail_b], 1)
    seq_bytes, seq_tot = _pack_bits(vals, bits, SSTREAM_CAP)
    lit_tot = torch.stack(lit_tot, 1)
    _check_totals(lit_tot, seq_tot)
    return torch.stack(lit_bytes, 1), lit_tot, seq_bytes, seq_tot


def stage(chunks, device):
    """The chunks as bytes and as a (B, width) uint8 batch with (B,) int32
    lengths on ``device``; raises ValueError for a chunk over 64 KB."""
    chunks = [bytes(c) for c in chunks]
    for i, c in enumerate(chunks):
        if len(c) > MAX_CHUNK:
            raise ValueError(f"chunk {i} exceeds the {MAX_CHUNK}-byte zstd device cap")
    width = max(16, -(-max(map(len, chunks), default=0) // 16) * 16)
    buf = np.zeros((len(chunks), width), np.uint8)
    for i, c in enumerate(chunks):
        buf[i, :len(c)] = np.frombuffer(c, np.uint8)
    device = torch.device(device)
    return (chunks, torch.from_numpy(buf).to(device),
            torch.tensor([len(c) for c in chunks], dtype=torch.int32, device=device))


# device_enc._Plan.reason of each reason code of the C++ planner ("" where
# the chunk is planned for the card)
REASONS = ("", "size", "nseq", "small-literals", "literal-shape", "incompressible-literals")
_ERRORS = {1: ValueError, 2: RuntimeError, 3: AssertionError}


def _flat(chunks):
    """The chunks one after another as uint8, and where each starts (B + 1)."""
    off = np.zeros(len(chunks) + 1, np.int64)
    np.cumsum([len(c) for c in chunks], out=off[1:])
    return np.frombuffer(b"".join(chunks), np.uint8), off


def _numpy_order(keys, n, out):
    """The C++ planner's callback: np.argsort's order of n int64 keys, as
    fse_enc.normalize_counts takes it (see encode_plan.cc)."""
    try:
        keys = np.ctypeslib.as_array(keys, (n,)).copy()
        np.ctypeslib.as_array(out, (n,))[:] = np.argsort(keys)
        return 0
    except Exception:  # it cannot cross into C++, where the planner raises instead
        traceback.print_exc()
        return 1


_ORDER = _build.ORDER_FN(_numpy_order)
# seq_enc._field_cost_bits' log2 of each normalised count -1..512 by numpy,
# where -1 counts as 0.5 and 0 as 1e-9
_LOG2 = np.log2(np.maximum(np.r_[0.5, np.arange(513.0)], 1e-9))


class Plans:
    """The C++ plans of a batch of chunks from their proposals, each
    ``device_enc._plan_chunk``'s: ``reason`` ("" where the chunk is planned
    for the card), ``device`` (bool) and ``rows`` (the planned chunks'
    indices, in order). ``pack`` and ``assemble`` are ``pack_plans`` and
    ``_assemble`` over the planned chunks; ``detail`` gives a chunk's
    Huffman table bytes and its fields' modes and descriptions."""

    def __init__(self, chunks, proposals):
        """``proposals``: each chunk's (literal lengths, offsets, match
        lengths), empty where it has none."""
        self._lib = _build.load_host()
        if len(proposals) != len(chunks):
            raise ValueError(f"{len(chunks)} chunks but {len(proposals)} proposals")
        counts = [len(p[0]) for p in proposals]
        if any(len(p[1]) != m or len(p[2]) != m for p, m in zip(proposals, counts)):
            raise ValueError("a chunk's literal lengths, offsets and match lengths differ "
                             "in length")
        data, data_off = _flat(chunks)
        seq_off = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum(counts, out=seq_off[1:])
        ll, of, ml = (np.concatenate([np.zeros(0, np.int64)]
                                     + [np.asarray(p[k], np.int64) for p in proposals])
                      for k in range(3))
        codes = np.zeros(len(chunks), np.int32)
        err = np.zeros(2, np.int64)
        msg = ctypes.create_string_buffer(256)
        self._handle = self._lib.acx_zstd_encode_plan(
            data.ctypes.data, data_off.ctypes.data, ll.ctypes.data, of.ctypes.data,
            ml.ctypes.data, seq_off.ctypes.data, len(chunks), _LOG2.ctypes.data, _ORDER,
            codes.ctypes.data, err.ctypes.data, err[1:].ctypes.data, msg, len(msg))
        if not self._handle:
            raise _ERRORS[int(err[0])](f"{msg.value.decode()} (chunk {int(err[1])})")
        self.reason = [REASONS[c] for c in codes]
        self.device = codes == 0
        self.rows = np.nonzero(self.device)[0].tolist()
        self.sizes = [len(c) for c in chunks]

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.acx_zstd_encode_plan_free(self._handle)
            self._handle = None

    def pack(self) -> dict:
        """``device_enc.pack_plans``' arrays for the planned chunks."""
        R = len(self.rows)
        shapes = {name: ((R, *shape), np.uint8 if dtype == torch.uint8 else np.int32)
                  for name, dtype, shape in EMIT_INPUTS}
        packed = {name: np.zeros(*spec) for name, spec in shapes.items()}
        self._lib.acx_zstd_encode_pack(self._handle, *(a.ctypes.data for a in packed.values()))
        return packed

    def assemble(self, lit_bytes, lit_tot, seq_bytes, seq_tot, digest) -> list[bytes]:
        """``_assemble`` for each planned chunk from the emission's outputs
        (one row a planned chunk) and its XXH64: its frame, or b"" where the
        block would not gain."""
        R = len(self.rows)
        arrays = []
        for a, dtype, shape in ((lit_bytes, np.uint8, (R, 4, LSTREAM_CAP)),
                                (lit_tot, np.int32, (R, 4)),
                                (seq_bytes, np.uint8, (R, SSTREAM_CAP)),
                                (seq_tot, np.int32, (R,)), (digest, np.int64, (R,))):
            a = np.ascontiguousarray(a, dtype)
            if a.shape != shape:
                raise ValueError(f"emission output of shape {a.shape}, want {shape}")
            arrays.append(a)
        out = np.zeros(sum(self.sizes[i] + 32 for i in self.rows), np.uint8)
        off = np.zeros(len(self.rows) + 1, np.int64)
        msg = ctypes.create_string_buffer(256)
        bad = self._lib.acx_zstd_encode_assemble(
            self._handle, *(a.ctypes.data for a in arrays), out.ctypes.data, off.ctypes.data,
            msg, len(msg))
        if bad >= 0:
            raise ValueError(msg.value.decode())
        return [out[off[r]:off[r + 1]].tobytes() for r in range(len(self.rows))]

    def detail(self, i: int) -> tuple[bytes, tuple, tuple]:
        """Chunk i's Huffman table bytes (``huff_enc.write_table``), its LL,
        OF and ML modes and their descriptions."""
        if not 0 <= i < len(self.reason):
            raise IndexError(f"no chunk {i} in a batch of {len(self.reason)}")
        modes = np.zeros(3, np.int32)
        lens = np.zeros(4, np.int64)
        buf = np.zeros(1024, np.uint8)
        self._lib.acx_zstd_encode_detail(self._handle, i, modes.ctypes.data, lens.ctypes.data,
                                         buf.ctypes.data)
        at = np.concatenate([[0], np.cumsum(lens)])
        parts = [buf[at[k]:at[k + 1]].tobytes() for k in range(4)]
        return parts[0], tuple(int(m) for m in modes), tuple(parts[1:])


def verify(chunks, ll, ml, of, nseq, last, min_match: int = zstd_dfast.MIN_MATCH) -> int:
    """``device_enc._verify_proposals`` over a batch, in C++: the first
    chunk with sequences (``nseq`` > 0) whose proposals are unsound, or -1.
    ``ll``, ``ml`` and ``of`` are (B, W) with each chunk's ``nseq`` first,
    ``last`` its trailing literal count."""
    nseq, last = (np.ascontiguousarray(a, np.int64) for a in (nseq, last))
    B, width = np.shape(ll)
    shapes_ok = (all(np.shape(a) == (B, width) for a in (ml, of)) and len(chunks) == B
                 and nseq.shape == last.shape == (B,))
    if not shapes_ok or (B and not 0 <= nseq.min() <= nseq.max() <= width):
        raise ValueError("verify takes (B, W) proposals with (B,) counts of at most W "
                         "and (B,) trailing literal counts for B chunks")
    live = np.arange(width)[None, :] < nseq[:, None]
    flat = [np.ascontiguousarray(np.asarray(a)[live], np.int64) for a in (ll, ml, of)]
    seq_off = np.zeros(len(chunks) + 1, np.int64)
    np.cumsum(nseq, out=seq_off[1:])
    data, data_off = _flat(chunks)
    check = np.ascontiguousarray(nseq > 0, np.uint8)
    return int(_build.load_host().acx_zstd_verify_proposals(
        data.ctypes.data, data_off.ctypes.data, *(a.ctypes.data for a in flat),
        seq_off.ctypes.data, last.ctypes.data, check.ctypes.data, len(chunks), min_match))


def match(chunks, raw, raw_lens) -> list:
    """The DFAST matcher kernel over the batch, then the host check
    (``verify``): each chunk's (ll, offsets, ml), or None where the kernel
    found no sequence. Raises RuntimeError naming the first chunk the kernel
    flagged not ok or whose proposals fail the check."""
    ll, ml, of, nseq, last, ok = zstd_dfast.find_sequences(raw, raw_lens)
    nseq, last, ok = (t.cpu().numpy().astype(np.int64) for t in (nseq, last, ok))
    width = int(nseq.max())
    ll, ml, of = (t[:, :width].cpu().numpy().astype(np.int64) for t in (ll, ml, of))
    unsound = verify(chunks, ll, ml, of, nseq, last)
    not_ok = np.nonzero(ok == 0)[0]
    if not_ok.size and (unsound < 0 or not_ok[0] <= unsound):
        raise RuntimeError(f"zstd matcher kernel flagged chunk {int(not_ok[0])} not ok")
    if unsound >= 0:
        raise RuntimeError(f"zstd matcher kernel proposed unsound sequences for chunk {unsound}")
    return [(ll[i, :m], of[i, :m], ml[i, :m]) if m else None for i, m in enumerate(nseq)]


def plan(chunks, level: int, pres) -> Plans:
    """The host plan of each chunk, from its proposals or, where it has none,
    from the host matcher."""
    global host_matcher_rows
    host_matcher_rows += sum(pre is None and 0 < len(c) for c, pre in zip(chunks, pres))
    empty = (np.zeros(0, np.int64),) * 3
    proposals = []
    for c, pre in zip(chunks, pres):
        if pre is None and 0 < len(c) <= LIT_CAP:
            pre = block_enc.find_sequences(np.frombuffer(c, np.uint8), _params(level, len(c)))[:3]
        proposals.append(pre if pre is not None else empty)
    return Plans(chunks, proposals)


def emit_plans(plans: Plans, device) -> dict:
    """The emission kernel once over the plans marked ``device``: ``rows``,
    their indices, and the four outputs of ``emit`` as numpy arrays."""
    if not plans.rows:
        return dict(rows=plans.rows)
    packed = plans.pack()
    out = emit(*(torch.from_numpy(packed[name]).to(device) for name, _, _ in EMIT_INPUTS))
    return dict(zip(("lit_bytes", "lit_tot", "seq_bytes", "seq_tot"),
                    (t.cpu().numpy() for t in out)), rows=plans.rows)


def assemble(chunks, plans: Plans, emitted: dict, raw, raw_lens, level: int) -> list[bytes]:
    """Each chunk's frame: from its emitted streams, with its checksum from
    the xxh64 kernel, or from the host encoder where it has none or its
    block would not gain."""
    global host_frame_rows
    outs = [b""] * len(chunks)
    rows_at = emitted["rows"]
    if rows_at:
        digest = xxhash.xxh64(raw, raw_lens).cpu().numpy()[rows_at]
        frames = plans.assemble(emitted["lit_bytes"], emitted["lit_tot"],
                                emitted["seq_bytes"], emitted["seq_tot"], digest)
        for i, frame in zip(rows_at, frames):
            outs[i] = frame
    for i, c in enumerate(chunks):
        if not outs[i]:
            outs[i] = frame_enc.compress_bytes(c, level)
            host_frame_rows += 1
    return outs


def compress_batch(chunks, level: int = 3, *, device_matcher: bool = True,
                   device="cuda") -> list[bytes]:
    """Compress chunks of at most 64 KB, one single-block zstd frame each
    with its checksum, on ``device``: ``stage``, ``match`` (at level 3),
    ``plan``, ``emit_plans`` and ``assemble``; see the module doc."""
    chunks, raw, raw_lens = stage(chunks, device)
    if not chunks:
        return []
    pres = [None] * len(chunks)
    if level == 3 and device_matcher:
        pres = match(chunks, raw, raw_lens)
    plans = plan(chunks, level, pres)
    return assemble(chunks, plans, emit_plans(plans, raw.device), raw, raw_lens, level)
