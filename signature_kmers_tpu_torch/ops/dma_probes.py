"""The card's own yardsticks: the six Pallas probes of
``benchmarks/pallas_dma_bench.py`` as Hopper kernels
(``csrc/dma_probes.cu``), each beside its plain version.

- ``sweep_bw``: the streaming rate of device memory, the whole table
  copied into on-chip memory ``reps_in_kernel`` times;
- ``row_dma_gather``: one copy per random 16-byte row, ``q`` in flight;
- ``block_dma_gather``: one copy of ``rpd`` 512-byte rows per random
  start, up to ``q`` in flight;
- ``v_take_axis0``, ``v_onehot_mxu``, ``v_take_lanes``: the three
  on-chip gathers (rows, rows by a one-hot product, words within a row).

The copy probes return a (1, 1) int32 word, the XOR of the first word of
each copy that starts a chunk, row or block, as the Pallas kernels do;
the gathers return their gathered rows.  Words are int32 tensors holding
the JAX script's uint32 bits.  A wrapper takes its plain version when its
tensors lie on the CPU; on CUDA tensors it launches its kernel.  Its
checks of device, dtype, shape, contiguity, alignment, arguments and
index ranges (and of v_onehot_mxu's 8-bit words) raise before any
launch, a value out of range as a ValueError that names its argument.  The range check reads the indices' least and greatest value
and so waits for the card; ``check_ranges=False`` leaves it out there, for
timing loops over inputs already checked.  The kernels stop (``__trap``)
on an index out of range all the same, a backstop that loses the
process's CUDA context.
"""

from __future__ import annotations

import torch

from . import cuda_launch as cl
from .hashing import to_i32

ROW_WORDS = 128           # words of a wide table's 512-byte row
SWEEP_COPY_ROWS = 128     # rows of one bulk copy of the sweep (64 KiB)
BLOCK_PIECE_ROWS = 64     # rows a slot of block_dma_gather holds (32 KiB)
BLOCK_RING_BYTES = 160 << 10  # shared memory of block_dma_gather's slots
SMEM_MAX = 232448         # dynamic shared memory a block may use
_GOLDEN = 2654435761      # the tables' multiplier (pallas_dma_bench.py:57)


def _table(rows: int, width: int, device) -> torch.Tensor:
    out = torch.empty((rows, width), dtype=torch.int32, device=device)
    flat = out.view(-1)
    step = 1 << 24
    for a in range(0, flat.numel(), step):
        b = min(a + step, flat.numel())
        flat[a:b] = to_i32(torch.arange(a, b, dtype=torch.int64,
                                        device=device) * _GOLDEN)
    return out


def make_table_w(rows: int, device="cuda") -> torch.Tensor:
    """(rows, 128) int32: word i = i * 2654435761 mod 2^32, the JAX
    script's 512-byte-row table (pallas_dma_bench.py:54)."""
    return _table(rows, ROW_WORDS, device)


def make_table_4(rows: int, device="cuda") -> torch.Tensor:
    """(rows, 4) int32, the same words in 16-byte rows (:62)."""
    return _table(rows, 4, device)


def _xor_all(x: torch.Tensor) -> torch.Tensor:
    """The XOR of every element of an int32 tensor, as (1, 1) int32."""
    x = x.reshape(-1)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        half = x.numel() // 2
        x = x[:half] ^ x[half:]
    if x.numel() == 0:
        x = torch.zeros(1, dtype=torch.int32, device=x.device)
    return x.reshape(1, 1)


def _check_table(tab: torch.Tensor, name: str, width: int):
    if tab.dim() != 2:
        raise ValueError(f"{name}: a 2-D table expected, got shape "
                         f"{tuple(tab.shape)}")
    cl.check(tab, name, torch.int32, (tab.shape[0], width))


def _check_range(idx: torch.Tensor, name: str, hi: int):
    """Every value of idx in [0, hi]: one read of its least and greatest
    value (on the card, a wait for it)."""
    if not idx.numel():
        return
    lo, top = torch.stack([idx.min(), idx.max()]).tolist()
    if lo < 0 or top > hi:
        raise ValueError(f"{name}: values must lie in [0, {hi}], got "
                         f"[{lo}, {top}]")


# -- the copy probes ---------------------------------------------------------

def sweep_bw_reference(tab, chunk_rows: int, reps_in_kernel: int):
    """Plain version of sweep_bw: the first word of each whole chunk of
    chunk_rows rows, XORed, once per rep (so 0 for an even count)."""
    _check_table(tab, "tab", ROW_WORDS)
    if chunk_rows < 1 or reps_in_kernel < 0:
        raise ValueError("chunk_rows must be >= 1 and reps >= 0")
    nchunks = tab.shape[0] // chunk_rows
    first = tab[:nchunks * chunk_rows:chunk_rows, 0]
    if reps_in_kernel % 2 == 0:
        first = first[:0]
    return _xor_all(first)


def sweep_bw(tab, chunk_rows: int, reps_in_kernel: int,
             copy_rows: int = SWEEP_COPY_ROWS):
    """Stream the table's first tab.shape[0] // chunk_rows whole chunks of
    chunk_rows rows from device memory into shared memory,
    reps_in_kernel times, and return sweep_bw_reference's word.

    tab: (R, 128) int32 (512-byte rows).  On the card every SM runs one
    block, which takes chunks in turn and streams each as bulk copies of
    copy_rows rows (64 KiB by default) through two slots: a block's shared
    memory holds two copies, not two of the TPU's 512 KiB chunks, so
    copy_rows, which must divide chunk_rows, sets the copy size and
    chunk_rows only the result."""
    if not cl.on_cuda(tab):
        return sweep_bw_reference(tab, chunk_rows, reps_in_kernel)
    _check_table(tab, "tab", ROW_WORDS)
    if (chunk_rows < 1 or copy_rows < 1 or chunk_rows % copy_rows
            or reps_in_kernel < 0):
        raise ValueError(f"chunk_rows ({chunk_rows}) must be a multiple of "
                         f"copy_rows ({copy_rows}) and reps >= 0")
    if 2 * copy_rows * ROW_WORDS * 4 + 128 > SMEM_MAX:
        raise ValueError(f"copy_rows {copy_rows}: two copies exceed a "
                         f"block's shared memory")
    cl.check_aligned(16, tab=tab)
    out = torch.zeros((1, 1), dtype=torch.int32, device=tab.device)
    cl.launch("sweep_bw", [tab.data_ptr(), tab.shape[0], chunk_rows,
                           reps_in_kernel, copy_rows, out.data_ptr()],
              tab.device)
    sweep_bw.launches += 1
    return out


sweep_bw.launches = 0


def _check_gather_ring(n: int, ring_bytes: int):
    if n * 4 + ring_bytes + 128 > SMEM_MAX:
        raise ValueError(f"{n} copies: their indices and the ring exceed a "
                         f"block's shared memory")


def row_dma_gather_reference(tab, idx, q: int):
    """Plain version of row_dma_gather: the XOR of tab[idx[j], 0]."""
    _check_table(tab, "tab", 4)
    cl.check(idx, "idx", torch.int32, (idx.numel(),))
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    _check_range(idx, "idx", tab.shape[0] - 1)
    return _xor_all(tab[idx.long(), 0])


ROW_QUEUES = (1, 2, 4, 8, 16, 32, 64, 128)  # row_dma_gather's q, card


def row_dma_gather(tab, idx, q: int, *, check_ranges: bool = True):
    """One 16-byte copy per row tab[idx[j]] into shared memory, q in
    flight from one warp (a latency probe, as the TPU's one core: min(q,
    32) lanes copy a step of rows, q / 32 steps in flight); returns
    row_dma_gather_reference's word.  tab: (R, 4) int32; idx: (n,) int32
    in [0, R); q one of ROW_QUEUES (the kernel's cp.async.wait_group takes
    the steps as a constant).  check_ranges: the module docstring."""
    if not cl.on_cuda(tab, idx):
        return row_dma_gather_reference(tab, idx, q)
    _check_table(tab, "tab", 4)
    cl.check(idx, "idx", torch.int32, (idx.numel(),))
    if q not in ROW_QUEUES:
        raise ValueError(f"q must be one of {ROW_QUEUES}, got {q}")
    _check_gather_ring(idx.numel(), max(q, 32) * 16)
    cl.check_aligned(16, tab=tab)
    if check_ranges:
        _check_range(idx, "idx", tab.shape[0] - 1)
    out = torch.zeros((1, 1), dtype=torch.int32, device=tab.device)
    cl.launch("row_dma_gather", [tab.data_ptr(), tab.shape[0], idx.data_ptr(),
                                 idx.numel(), q, out.data_ptr()], tab.device)
    row_dma_gather.launches += 1
    return out


row_dma_gather.launches = 0


def block_dma_geometry(rpd: int, q: int = 16) -> tuple[int, int]:
    """(piece_rows, depth) of block_dma_gather on the card: a block of rpd
    rows is copied as pieces of at most BLOCK_PIECE_ROWS rows (32 KiB),
    and depth copies are in flight, each from its own issuing thread and
    slot: q, or as many as BLOCK_RING_BYTES hold."""
    piece = min(rpd, BLOCK_PIECE_ROWS)
    return piece, max(1, min(q, BLOCK_RING_BYTES // (piece * ROW_WORDS * 4)))


def _starts(starts, n_dma: int):
    cl.check(starts, "starts", torch.int32, (starts.numel(),))
    if not 0 <= n_dma <= starts.numel():
        raise ValueError(f"n_dma {n_dma} outside [0, {starts.numel()}]")
    return starts[:n_dma]


def block_dma_gather_reference(tab, starts, rpd: int, n_dma: int,
                               q: int = 16):
    """Plain version of block_dma_gather: the XOR of tab[starts[j], 0]
    over the first n_dma starts, each in [0, R - rpd]."""
    _check_table(tab, "tab", ROW_WORDS)
    if rpd < 1 or q < 1:
        raise ValueError("rpd and q must be >= 1")
    s = _starts(starts, n_dma)
    _check_range(s, "starts", tab.shape[0] - rpd)
    return _xor_all(tab[s.long(), 0])


def block_dma_gather(tab, starts, rpd: int, n_dma: int, q: int = 16, *,
                     check_ranges: bool = True):
    """One copy of rows starts[j] .. starts[j] + rpd - 1 into shared
    memory per start, j < n_dma, from one issuing thread; returns
    block_dma_gather_reference's word.  tab: (R, 128) int32; starts: int32
    in [0, R - rpd].  A copy that exceeds a slot goes as pieces, and the
    copies in flight follow its shared memory (block_dma_geometry): at
    most q, q <= 128.  check_ranges: the module docstring."""
    if not cl.on_cuda(tab, starts):
        return block_dma_gather_reference(tab, starts, rpd, n_dma, q)
    _check_table(tab, "tab", ROW_WORDS)
    if rpd < 1 or not 1 <= q <= 128 or rpd > tab.shape[0]:
        raise ValueError(f"rpd {rpd} and q {q} must be >= 1, q at most 128 "
                         f"and rpd the table's {tab.shape[0]} rows")
    s = _starts(starts, n_dma)
    piece, depth = block_dma_geometry(rpd, q)
    _check_gather_ring(n_dma, depth * piece * ROW_WORDS * 4)
    cl.check_aligned(16, tab=tab)
    if check_ranges:
        _check_range(s, "starts", tab.shape[0] - rpd)
    out = torch.zeros((1, 1), dtype=torch.int32, device=tab.device)
    cl.launch("block_dma_gather", [tab.data_ptr(), tab.shape[0], s.data_ptr(),
                                   n_dma, rpd, piece, depth, out.data_ptr()],
              tab.device)
    block_dma_gather.launches += 1
    return out


block_dma_gather.launches = 0


# -- the on-chip gathers -----------------------------------------------------

def _check_column(idx, name: str):
    if idx.dim() != 2:
        raise ValueError(f"{name}: shape (n, 1) expected, got "
                         f"{tuple(idx.shape)}")
    cl.check(idx, name, torch.int32, (idx.shape[0], 1))


def v_take_axis0_reference(tab, idx):
    """Plain version of v_take_axis0: out[i, :] = tab[idx[i, 0], :]."""
    _check_table(tab, "tab", ROW_WORDS)
    _check_column(idx, "idx")
    _check_range(idx, "idx", tab.shape[0] - 1)
    return tab[idx[:, 0].long()]


def v_take_axis0(tab, idx, *, check_ranges: bool = True):
    """out[i, :] = tab[idx[i, 0], :] by a direct gather through L2.

    tab: (R, 128) int32; idx: (n, 1) int32 in [0, R) -> (n, 128) int32.
    A warp copies a row, a lane's 16 bytes of it, straight from the table
    (which L2 holds across calls).  check_ranges: the module docstring."""
    if not cl.on_cuda(tab, idx):
        return v_take_axis0_reference(tab, idx)
    _check_table(tab, "tab", ROW_WORDS)
    _check_column(idx, "idx")
    cl.check_aligned(16, tab=tab)
    if check_ranges:
        _check_range(idx, "idx", tab.shape[0] - 1)
    out = torch.empty((idx.shape[0], ROW_WORDS), dtype=torch.int32,
                      device=tab.device)
    cl.launch("v_take_axis0", [tab.data_ptr(), tab.shape[0], idx.data_ptr(),
                               idx.shape[0], out.data_ptr()], tab.device)
    v_take_axis0.launches += 1
    return out


v_take_axis0.launches = 0


def _check_words(small):
    """small's words of at most 8 bits: the float32 product is exact only
    for them."""
    _check_range(small, "small (8-bit words)", 0xFF)


def v_onehot_mxu_reference(small, idx):
    """Plain version of v_onehot_mxu: onehot(idx[:, 0]) @ small with
    float32 accumulation, as the JAX kernel computes it: exact for words
    of at most 8 bits, which it requires (= small[idx[:, 0]])."""
    _check_table(small, "small", ROW_WORDS)
    _check_column(idx, "idx")
    _check_range(idx, "idx", small.shape[0] - 1)
    _check_words(small)
    rows = torch.arange(small.shape[0], device=idx.device)
    onehot = (rows[None, :] == idx.long()).to(torch.float32)
    return (onehot @ small.to(torch.float32)).to(torch.int32)


def v_onehot_mxu(small, idx, *, check_ranges: bool = True):
    """out = onehot(idx[:, 0]) @ small on the tensor cores (mma.sync u8 x
    u8 -> s32, every k), each block a slice of rows x columns that packs
    its columns of small to u8 as they arrive.  small: (K, 128) int32
    words of at most 8 bits, K a multiple of 32 up to 1024; idx: (n, 1)
    int32 in [0, K) -> (n, 128) int32 = small[idx[:, 0]].  check_ranges
    (the module docstring) covers the words too."""
    if not cl.on_cuda(small, idx):
        return v_onehot_mxu_reference(small, idx)
    _check_table(small, "small", ROW_WORDS)
    _check_column(idx, "idx")
    K = small.shape[0]
    if K < 32 or K % 32 or K > 1024:
        raise ValueError(f"small: a multiple of 32 rows up to 1024 expected, "
                         f"got {K}")
    cl.check_aligned(16, small=small)
    if check_ranges:
        _check_range(idx, "idx", K - 1)
        _check_words(small)
    out = torch.empty((idx.shape[0], ROW_WORDS), dtype=torch.int32,
                      device=small.device)
    cl.launch("v_onehot_mxu", [small.data_ptr(), K, idx.data_ptr(),
                               idx.shape[0], out.data_ptr()], small.device)
    v_onehot_mxu.launches += 1
    return out


v_onehot_mxu.launches = 0


def v_take_lanes_reference(idx, tab):
    """Plain version of v_take_lanes: out[i, j] = tab[i, idx[i, j]]."""
    _check_table(tab, "tab", ROW_WORDS)
    cl.check(idx, "idx", torch.int32, tab.shape)
    _check_range(idx, "idx", ROW_WORDS - 1)
    return torch.gather(tab, 1, idx.long())


def v_take_lanes(idx, tab, *, check_ranges: bool = True):
    """out[i, j] = tab[i, idx[i, j]]: a warp per row, the row's words in
    registers, each output fetched by a shuffle.  idx, tab: (n, 128) int32,
    idx in [0, 128) -> (n, 128) int32.  check_ranges: the module
    docstring."""
    if not cl.on_cuda(idx, tab):
        return v_take_lanes_reference(idx, tab)
    _check_table(tab, "tab", ROW_WORDS)
    cl.check(idx, "idx", torch.int32, tab.shape)
    cl.check_aligned(16, idx=idx, tab=tab)
    if check_ranges:
        _check_range(idx, "idx", ROW_WORDS - 1)
    out = torch.empty_like(tab)
    cl.launch("v_take_lanes", [idx.data_ptr(), tab.data_ptr(), tab.shape[0],
                               out.data_ptr()], tab.device)
    v_take_lanes.launches += 1
    return out


v_take_lanes.launches = 0

# every wrapper with its plain version, in the JAX script's order
PROBES = {
    "sweep_bw": (sweep_bw, sweep_bw_reference),
    "row_dma_gather": (row_dma_gather, row_dma_gather_reference),
    "block_dma_gather": (block_dma_gather, block_dma_gather_reference),
    "v_take_axis0": (v_take_axis0, v_take_axis0_reference),
    "v_onehot_mxu": (v_onehot_mxu, v_onehot_mxu_reference),
    "v_take_lanes": (v_take_lanes, v_take_lanes_reference),
}
