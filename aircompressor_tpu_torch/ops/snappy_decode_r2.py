"""Batched Snappy block decode, the r2 design: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``aircompressor_tpu.ops.snappy_pallas8.decode``, the JAX
package's r2 Snappy decode, kept there as an ablation baseline beside the
production decode (``snappy_decode`` here). Its loop emits one output
window an iteration: at most 128 bytes, inside one 128-byte-aligned block
of the output, and for a copy at most ``dist`` bytes, after which ``dist``
doubles (capped at 64 KB) because the bytes just written repeat the
pattern.

The contract is ``snappy_decode``'s: ``comp`` a (B, cap) uint8 batch of
zero-padded chunks that start with the varint uncompressed length,
``comp_lens`` the (B,) compressed lengths; ``(out, out_lens, ok)`` with
zeros at and past each output length, a malformed chunk stopped at its bad
token with ``out_lens`` the bytes produced before it, ``ok`` requiring
``out_lens <= out_cap``. A 4-byte copy offset with a nonzero high byte
fails.

``with_steps=True`` adds ``steps``, (B,) int32, the function the JAX kernel
defines: it decodes 32 chunks a grid step, and runs its loop until none of
them is live, so each row gets the largest count of its group of 32 (rows
32g to 32g + 31; rows past B count 0). A chunk's count is the iterations
during which it is live: one a window, and one for a token that fails its
parse. A chunk rejected before its first token counts 0. As in the JAX
kernel, the varint length is a signed 32-bit value there, so a length with
bit 31 set is not rejected at once: its first token fails, and counts 1.

Where the port differs from ``snappy_pallas8`` (ROADMAP F10): a 4-byte
literal length of 0xFFFFFFFF wraps to an empty literal in the JAX kernel's
int32 arithmetic, and the port rejects it, as the host decoders and
``snappy_decode`` do; a compressed length past the row is rejected before
the first token, as in ``snappy_decode``, where the JAX kernel reads the
zeros of its padding.

``decode`` launches ``csrc/snappy_decode_r2.cu`` for a CUDA tensor and
uses ``decode_plain`` only for a tensor on the CPU. The kernel keeps the
loop above and each chunk's input in a shared-memory ring and its recent
output in a shared-memory window (``WINDOWS``, two instantiations of one
template): 32 KB up to ``SMALL_BATCH`` chunks, 4 KB above, so that 4096
chunks fit the card in one wave. A copy with ``dist`` up to ``copy_reach``
reads the window, a farther one device memory.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .. import _build
from . import snappy_decode
from ._rows import MAX_CHUNK as MAX_OUT, check_decode_args

GROUP = 32  # chunks a grid step of the JAX kernel: the rows that share a count
WINDOW = 128  # bytes of output an iteration emits at most, aligned to 128
WINDOWS = (4096, 32768)  # the kernel's output windows in shared memory, in bytes
SMALL_BATCH = 792  # the most chunks that take the 32 KB window (kSmallBatchChunks)

# Kernel launches and the chunks they decoded, for runs that must show the
# kernel was used. Only a launch of the CUDA kernel adds to them.
launches = 0
rows = 0


def copy_reach(window: int) -> int:
    """The farthest copy distance the kernel reads from a shared-memory
    window of this size (window - window / 16: an iteration adds at most 128
    bytes, and a drain waits for half the window); a farther copy reads
    device memory."""
    return window - window // 16


def decode(comp: torch.Tensor, comp_lens: torch.Tensor,
           out_cap: int = MAX_OUT, with_steps: bool = False):
    """Decode B Snappy blocks of at most 64 KB each; see the module doc."""
    global launches, rows
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_lens, out_cap, with_steps)
    if comp.device.type != "cuda":
        raise ValueError(f"no Snappy r2 decode for device {comp.device}")
    lib = _build.load()
    B, cap = comp.shape
    out = torch.empty((B, out_cap), dtype=torch.uint8, device=comp.device)
    out_lens = torch.empty(B, dtype=torch.int32, device=comp.device)
    ok = torch.empty(B, dtype=torch.bool, device=comp.device)
    steps = torch.empty(B, dtype=torch.int32, device=comp.device) if with_steps else None
    if B:
        with torch.cuda.device(comp.device):
            err = lib.acx_snappy_decode_r2(
                comp.data_ptr(), comp_lens.data_ptr(), B, cap, out.data_ptr(),
                out_lens.data_ptr(), ok.data_ptr(), out_cap,
                steps.data_ptr() if with_steps else None,
                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(
                f"snappy r2 decode kernel launch failed: CUDA error {err}")
        launches += 1
        rows += B
    result = (out, out_lens, ok & (out_lens <= out_cap))
    return result + (group_max(steps),) if with_steps else result


def group_max(counts: torch.Tensor) -> torch.Tensor:
    """Each row's count replaced by the largest of its group of 32 rows.

    Tensor ops over B / 32 groups, apart from the kernel: the kernel keeps
    its blocks small (4 warps) to fill the card, so a group spans 8 blocks
    and has no place inside one to meet."""
    B = counts.shape[0]
    padded = torch.nn.functional.pad(counts, (0, (-B) % GROUP))
    peak = padded.view(-1, GROUP).amax(1)
    return peak.repeat_interleave(GROUP)[:B].to(torch.int32)


def decode_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                 out_cap: int = MAX_OUT, with_steps: bool = False):
    """Plain PyTorch decode with the kernel's results, for tests and checks.

    Bytes, lengths and ``ok`` are ``snappy_decode.decode_plain``'s (the same
    function); the step counts come from its token table by
    ``chunk_steps``."""
    comp, comp_lens = check_decode_args(comp, comp_lens, out_cap)
    t = snappy_decode.token_table(comp, comp_lens)
    result = snappy_decode.results(t, out_cap)
    if not with_steps:
        return result
    return result + (group_max(chunk_steps(t, comp_lens)),)


def chunk_steps(t: SimpleNamespace, comp_lens: torch.Tensor) -> torch.Tensor:
    """(B,) iterations during which each chunk is live, before the group
    maximum. A literal of L bytes from output offset op spans
    ``((op + L - 1) >> 7) - (op >> 7) + 1`` windows; the copies are stepped
    window by window, all copies of the batch at once (a copy is at most 64
    bytes, so a few rounds). A failing token adds 1."""
    B, width = t.is_tok.shape
    clen = comp_lens.to(torch.int64)
    last = torch.where(t.any_bad, t.first_bad[:, 0], width - 1)
    emits = t.is_tok & (t.pos < last[:, None])  # the tokens before the bad one
    lit_windows = ((t.op_at + t.length - 1) >> 7) - (t.op_at >> 7) + 1
    count = torch.where(emits & t.is_lit, lit_windows, 0).sum(1)

    row, col = (emits & ~t.is_lit).nonzero(as_tuple=True)
    op, rem, dist = t.op_at[row, col], t.length[row, col], t.dist[row, col]
    while bool((rem > 0).any()):
        live = rem > 0
        take = torch.minimum(torch.minimum(rem, WINDOW - (op & (WINDOW - 1))), dist)
        take = torch.where(live, take, 0)
        count.index_add_(0, row, live.to(torch.int64))
        dist = torch.where(live & (take == dist), (2 * dist).clamp(max=MAX_OUT), dist)
        op, rem = op + take, rem - take
    count = count + t.any_bad.to(torch.int64)
    # A varint length with bit 31 set is negative in the JAX kernel: not
    # rejected at once, but its first token fails.
    negative = (t.declared >= 2**31) & (t.vlen < clen) & (clen <= width - 1)
    return torch.where(negative, 1, count)
