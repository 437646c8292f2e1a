// The card's own yardsticks: the six Pallas probes of
// benchmarks/pallas_dma_bench.py, each computing what its Pallas kernel
// computes, designed for Hopper rather than copied block by block.
//
// Replaces (benchmarks/pallas_dma_bench.py):
//   skt_sweep_bw          sweep_bw (line 107): streaming rate of device
//                         memory, the whole table copied into on-chip
//                         memory `reps` times;
//   skt_row_dma_gather    row_dma_gather (:172): one copy per random
//                         16-byte row, q copies in flight;
//   skt_block_dma_gather  block_dma_gather (:227): one copy of rpd
//                         512-byte rows per random start;
//   skt_v_take_axis0      v_take_axis0 (:302): a row gather inside
//                         on-chip memory, out[i, :] = tab[idx[i], :];
//   skt_v_onehot_mxu      v_onehot_mxu (:322): the same gather as a
//                         one-hot product on the matrix units;
//   skt_v_take_lanes      v_take_lanes (:354): a gather across the 128
//                         words of a row, out[i, j] = tab[i, idx[i, j]].
// The three copy probes return (1, 1): the XOR of the first word of every
// copy that starts a chunk (sweep), of every row (row gather) or of every
// block (block gather), XORed into out[0] (zeroed by the caller).
//
// Bounds on the H100.  The sweep is bound by the 3.35 TB/s of device
// memory; the row and block gathers by the latency of a random read from
// one issuing context, as on the TPU's one core (n / q x a round trip of
// ~270 ns for the row gather), far above their bytes.  The three on-chip
// gathers are bound by the bytes of their indices, their output and the
// table rows they select; v_onehot_mxu's product is 0.27 us at the int8
// tensor-core rate, under its bytes.
// Design:
// - the sweep's and the block gather's copies are 1-D bulk copies
//   (cp.async.bulk, the TMA) from device memory into shared-memory slots,
//   each slot's arrival counted by an mbarrier
//   (mbarrier::complete_tx::bytes): the counterpart of make_async_copy
//   into VMEM with a DMA semaphore.  On the H100 one thread's bulk copies
//   did not overlap: copies of 16 bytes to 32 KiB each took about one
//   memory round trip, at any ring depth (PERF.md, section 6).  So the
//   sweep runs one issuing thread with two slots on every SM, taking
//   copies in turn (a copy of 64 KiB is long enough to stream at the
//   card's rate), and the block gather one block whose `issuers` threads
//   each keep one copy in flight.  A block holds at most 227 KB of shared
//   memory, so a TPU chunk of 512 KiB is streamed as pieces of
//   `piece_rows` rows, and a block of rpd rows that does not fit a slot
//   likewise; every byte is copied;
// - the row gather, a latency probe (one issuing context, as the TPU's
//   scalar core), is one warp with a ring of q 16-byte cp.async copies:
//   min(q, 32) lanes a step, one commit group a step, q / 32 steps in
//   flight, each lane waiting for its oldest (cp.async.wait_group).  One
//   thread's ring of q copies took the same time a row at every q from 4
//   to 64 (PERF.md, section 6);
// - the gathers read their indices or starts from shared memory, loaded
//   before the ring starts (the TPU prefetches them into SMEM);
// - v_take_axis0: the TPU holds the 4 MiB table in VMEM; on Hopper the
//   on-chip memory that holds it is the 50 MB L2, not a block's 227 KB
//   (staging it through shared memory in panels copies ~24 MiB to
//   deliver 2 MiB: PERF.md, section 6).  So a warp copies a
//   row straight from the table, a lane's 16 bytes, and one wave of warps
//   covers the indices: the time is an index read and a row read from L2,
//   not a copy of the table;
// - v_onehot_mxu: all SMs busy and little to stage.  A block owns 256
//   rows x a 16-column slice (128 blocks at 4096 rows, not 32), so it
//   stages k_rows x 16 words (32 KiB at 512 rows, an eighth of the
//   table) with four 16-byte loads a thread, packed to u8 in registers
//   into a K-major layout whose stores and ldmatrix reads are free of
//   bank conflicts.  The product runs on the tensor cores over every k
//   (mma.sync m16n8k32 u8 x u8 -> s32); a row's one-hot A is one a-word,
//   found once from its index, so a k-step costs two compares and four
//   selects, one ldmatrix and two mma;
// - v_take_lanes: a warp per row, the row's 128 words in registers (4 a
//   lane); each output is fetched by __shfl_sync from lane idx >> 2, one
//   shuffle per register, and word idx & 3 selected.
// Shared-memory limits are raised once per kernel and device, and the SM
// count read once per device, not on every call.
// An index out of range, a start past the last whole block, or a table
// word of v_onehot_mxu above 8 bits stops the kernel (__trap): the next
// synchronisation raises.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int RING_THREADS = 128;  // a ring block: it loads the indices
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_DEVICES = 64;

using DeviceBits = std::atomic<unsigned long long>;

// Raises a kernel's dynamic shared memory limit to SMEM_MAX once on each
// device (bit d of `done`), not on every launch: the limit only allows,
// and each launch still asks for what it uses.
cudaError_t allow_smem_max(const void *kernel, DeviceBits &done) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < MAX_DEVICES ? 1ull << dev : 0;
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return e;
}

// the SMs of the current device, read once per device
int sm_count() {
    static std::atomic<int> counts[MAX_DEVICES];
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
    if (dev < MAX_DEVICES && (n = counts[dev].load()) > 0) return n;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
        return 0;
    if (dev < MAX_DEVICES) counts[dev].store(n);
    return n;
}

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t *bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
    asm volatile(
        "{\n\t"
        ".reg .pred P1;\n\t"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra DONE;\n\t"
        "bra WAIT;\n\t"
        "DONE:\n\t"
        "}" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16) from src to dst (both 16-byte aligned), its
// arrival counted on bar
__device__ __forceinline__ void bulk_copy(void *dst, const void *src,
                                          uint32_t bytes, uint64_t *bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

struct Ring {
    const unsigned char *src;  // the table, row_bytes a row
    int row_bytes;
    const int *starts;         // start row of copy k, or NULL: sequential
    long n_copies;
    int rows_per_copy;
    long seq_copies;           // starts NULL: copy k starts at row
                               // (k % seq_copies) * rows_per_copy
    long max_start;            // largest start row a copy may have
    int piece_rows;            // rows a slot holds (a copy's piece)
    int issuers;               // threads of a block that issue copies
    int depth;                 // slots in each issuer's ring
};

__host__ __device__ inline long bars_bytes(int n) {
    return (n * 8L + 127) / 128 * 128;
}

// Issuer t of block b takes copies c = b * issuers + t,
// c + gridDim.x * issuers, ...; it keeps `depth` pieces in flight through
// its own slots and XORs the first word of each copy's first piece.
// Shared memory: the mbarriers, the slots, then (starts given) the n
// starts.
__device__ __forceinline__ void run_ring(const Ring &r, uint32_t *out) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int slots_n = r.issuers * r.depth;
    const long piece_bytes = (long)r.piece_rows * r.row_bytes;
    uint64_t *bars = reinterpret_cast<uint64_t *>(smem);
    unsigned char *slots = smem + bars_bytes(slots_n);
    int *starts = reinterpret_cast<int *>(slots + slots_n * piece_bytes);
    if (r.starts) {
        for (long k = threadIdx.x; k < r.n_copies; k += blockDim.x)
            starts[k] = r.starts[k];
        __syncthreads();
    }
    const int t = threadIdx.x;
    if (t >= r.issuers) return;
    bars += t * r.depth;
    slots += t * r.depth * piece_bytes;
    for (int s = 0; s < r.depth; s++) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const long first_copy = (long)blockIdx.x * r.issuers + t;
    const long stride = (long)gridDim.x * r.issuers;
    const int ppc = (r.rows_per_copy + r.piece_rows - 1) / r.piece_rows;
    const long mine = r.n_copies > first_copy
        ? (r.n_copies - first_copy + stride - 1) / stride : 0;
    const long total = mine * ppc;
    auto issue = [&](long i) {
        const long m = i / ppc;
        const int p = (int)(i - m * ppc);
        const long k = first_copy + m * stride;
        long start;
        if (r.starts) {
            start = starts[k];
            if (start < 0 || start > r.max_start) __trap();
        } else {
            start = k % r.seq_copies * r.rows_per_copy;
        }
        const int first = p * r.piece_rows;
        const int rows = min(r.piece_rows, r.rows_per_copy - first);
        const uint32_t bytes = (uint32_t)rows * r.row_bytes;
        const int slot = (int)(i % r.depth);
        // the slot was last read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bars + slot, bytes);
        bulk_copy(slots + slot * piece_bytes,
                  r.src + (start + first) * (long)r.row_bytes, bytes,
                  bars + slot);
    };
    for (long i = 0; i < total && i < r.depth; i++) issue(i);
    uint32_t acc = 0;
    for (long w = 0; w < total; w++) {
        const int slot = (int)(w % r.depth);
        mbar_wait(bars + slot, (uint32_t)((w / r.depth) & 1));
        if (w % ppc == 0)
            acc ^= *reinterpret_cast<const uint32_t *>(slots +
                                                       slot * piece_bytes);
        if (w + r.depth < total) issue(w + r.depth);
    }
    if (total) atomicXor(out, acc);
}

// sweep_bw: sequential chunks, one issuer with two slots on every SM
__global__ void sweep_kernel(Ring r, uint32_t *out) { run_ring(r, out); }

// block_dma_gather: copies at the given starts, an issuer a copy in flight
__global__ void block_gather_kernel(Ring r, uint32_t *out) {
    run_ring(r, out);
}

int launch_ring(void (*kernel)(Ring, uint32_t *), DeviceBits &smem_set,
                const Ring &r, int grid, void *out, cudaStream_t stream) {
    const long slots_n = (long)r.issuers * r.depth;
    const long smem = bars_bytes((int)slots_n) + slots_n * r.piece_rows *
        r.row_bytes + (r.starts ? r.n_copies * 4 : 0);
    if (r.depth < 1 || r.issuers < 1 || r.issuers > RING_THREADS ||
        r.piece_rows < 1 || r.rows_per_copy < 1 || smem > SMEM_MAX ||
        (r.piece_rows * (long)r.row_bytes) % 16)
        return (int)cudaErrorInvalidValue;
    if (r.n_copies <= 0) return (int)cudaGetLastError();
    cudaError_t e = allow_smem_max((const void *)kernel, smem_set);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, RING_THREADS, smem, stream>>>(r, (uint32_t *)out);
    return (int)cudaGetLastError();
}

// ---- row_dma_gather: one warp's ring of 16-byte cp.async copies -----------

template <int G>
__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;" :: "n"(G - 1) : "memory");
}

// Warp 0 copies rows in steps of `lanes` rows, step s's row s * lanes + l
// by lane l < lanes, one commit group a step, G steps in flight (lanes *
// G = q copies); each lane waits for its oldest step, XORs that slot's
// first word and reuses the slot.  The indices are loaded into shared
// memory first.
template <int G>
__global__ void row_ring_kernel(const uint4 *__restrict__ tab, long rows,
                                const int *__restrict__ idx, long n,
                                int lanes, uint32_t *out) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint4 *slot = reinterpret_cast<uint4 *>(smem);  // [G][32]
    int *ix = reinterpret_cast<int *>(slot + G * 32);
    for (long k = threadIdx.x; k < n; k += blockDim.x) ix[k] = idx[k];
    __syncthreads();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const long steps = (n + lanes - 1) / lanes;
    long issued = 0;
    auto issue = [&]() {
        const long j = issued * lanes + lane;
        if (lane < lanes && j < n) {
            const int row = ix[j];
            if (row < 0 || row >= rows) __trap();
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                         :: "r"(smem_addr(slot + issued % G * 32 + lane)),
                            "l"(tab + row) : "memory");
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        issued++;
    };
    while (issued < G && issued < steps) issue();
    uint32_t acc = 0;
    for (long w = 0; w < steps; w++) {
        // step w is done once at most issued - w - 1 groups are pending
        if (issued - w - 1 >= G - 1)
            cp_async_wait_ring<G>();
        else
            asm volatile("cp.async.wait_all;" ::: "memory");
        if (lane < lanes && w * lanes + lane < n)
            acc ^= slot[w % G * 32 + lane].x;
        if (issued < steps) issue();
    }
    for (int d = 16; d; d >>= 1) acc ^= __shfl_xor_sync(FULL, acc, d);
    if (lane == 0) atomicXor(out, acc);
}

template <int G>
int launch_row_ring(const void *tab, long rows, const void *idx, long n,
                    int lanes, void *out, cudaStream_t stream) {
    const long smem = G * 32 * 16L + n * 4;
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    static DeviceBits smem_set;
    cudaError_t e = allow_smem_max((const void *)row_ring_kernel<G>,
                                   smem_set);
    if (e != cudaSuccess) return (int)e;
    row_ring_kernel<G><<<1, RING_THREADS, smem, stream>>>(
        (const uint4 *)tab, rows, (const int *)idx, n, lanes,
        (uint32_t *)out);
    return (int)cudaGetLastError();
}

// ---- v_take_axis0: a direct row gather through L2 -------------------------

constexpr int TAKE_THREADS = 256;
constexpr int TAKE_WARPS = TAKE_THREADS / 32;

// Warp w copies output row w, then strides by the grid's warps: every
// lane reads the row's index (one broadcast load), checks it, and moves
// its 16 of the row's 512 bytes with one 16-byte load and one streaming
// store (__stcs).
__global__ void __launch_bounds__(TAKE_THREADS) take_rows_kernel(
        const uint4 *__restrict__ tab, long n_rows,
        const int *__restrict__ idx, long n, uint4 *__restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long warps = (long)gridDim.x * TAKE_WARPS;
    for (long i = (long)blockIdx.x * TAKE_WARPS + (threadIdx.x >> 5); i < n;
         i += warps) {
        const int row = idx[i];
        if (row < 0 || row >= n_rows) __trap();
        __stcs(out + i * 32 + lane, tab[(long)row * 32 + lane]);
    }
}

// ---- v_onehot_mxu: one-hot product on the tensor cores ---------------------

constexpr int N_COLS = 128;      // the table's width
constexpr int MMA_ROWS = 256;    // output rows a block: a warp per 16
constexpr int MMA_COLS = 16;     // output columns a block (its slice)
constexpr int MMA_THREADS = MMA_ROWS * 2;
constexpr int MMA_TILES = MMA_COLS / 8;               // n-tiles of a warp
constexpr int MMA_QUADS = MMA_COLS / 4;               // 16-byte loads a row
constexpr int MMA_CHUNK = 4 * MMA_THREADS / MMA_QUADS;  // table rows a stage
constexpr int MMA_MAX_CHUNKS = 1024 / MMA_CHUNK;

// words a column of the packed slice takes: 4 k a word, padded to 4 mod
// 32 so that the staging stores and ldmatrix's rows are free of bank
// conflicts
__host__ __device__ constexpr int packed_stride(int k_rows) {
    return (k_rows / 4 + 31) / 32 * 32 + 4;
}

__device__ __forceinline__ uint32_t word(uint4 v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A row's one-hot A fragment: its 1 lies in k-step ks (of 32), where this
// lane's a-word is lo (k 0-15 of the step) or hi (k 16-31); every other
// k-step's a-words are 0.  A row past n has no 1 (ks < 0).
struct OneHotRow {
    int ks;
    uint32_t lo, hi;
};

__device__ __forceinline__ OneHotRow onehot_row(int i, int tig) {
    const int k = i & 31;
    const uint32_t w = ((k >> 2) & 3) == tig ? 1u << (8 * (k & 3)) : 0u;
    return {i >> 5, k < 16 ? w : 0u, k < 16 ? 0u : w};
}

// Block (x, y): output rows MMA_ROWS x .. + MMA_ROWS - 1, columns MMA_COLS
// y .. + MMA_COLS - 1.  The block stages its slice of the table, k_rows x
// MMA_COLS words, in chunks of MMA_CHUNK rows (one at 512 rows): a thread
// loads 4 rows x 4 words (four 16-byte loads), checks them, packs them
// into 4 words of four k each, one per column, stores them K-major and
// loads its part of the next chunk.  After each chunk's barrier, warp w
// multiplies its 16 rows' one-hot A, made in
// registers from the indices, by the chunk's k-steps of 32: ldmatrix
// reads B for both n-tiles, mma.sync m16n8k32 u8 x u8 -> s32 adds.
__global__ void __launch_bounds__(MMA_THREADS) onehot_kernel(
        const uint4 *__restrict__ small, int k_rows,
        const int *__restrict__ idx, long n, int *__restrict__ out) {
    extern __shared__ __align__(16) uint32_t bt[];  // [MMA_COLS][stride]
    const int stride = packed_stride(k_rows);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int chunks = (k_rows + MMA_CHUNK - 1) / MMA_CHUNK;
    // this thread's quad (4 columns) and first group of four k: a warp
    // covers 2 quads x 16 groups, so a 16-byte load of a warp reads 16
    // whole 32-byte sectors, and a store hits 32 banks
    const int quad = 2 * (warp % (MMA_QUADS / 2)) + (lane & 1);
    const int k4_first = 16 * (warp / (MMA_QUADS / 2)) + ((lane >> 1) & 15);
    const uint4 *src = small + (long)blockIdx.y * MMA_QUADS + quad;
    uint4 v[MMA_MAX_CHUNKS][4];
    auto load = [&](int c, uint4 (&d)[4]) {
        const int k4 = c * (MMA_CHUNK / 4) + k4_first;
        if (k4 < k_rows / 4) {
#pragma unroll
            for (int r = 0; r < 4; r++)
                d[r] = src[(long)(4 * k4 + r) * (N_COLS / 4)];
        }
    };
    load(0, v[0]);
    const int g = lane >> 2, tig = lane & 3;
    const long r0 = (long)blockIdx.x * MMA_ROWS + warp * 16 + g;
    const long r1 = r0 + 8;
    int i0 = -1000, i1 = -1000;  // rows past n: no 1 anywhere
    if (r0 < n) i0 = idx[r0];
    if (r1 < n) i1 = idx[r1];
    if ((r0 < n && (i0 < 0 || i0 >= k_rows)) ||
        (r1 < n && (i1 < 0 || i1 >= k_rows)))
        __trap();
    const OneHotRow h0 = onehot_row(i0, tig), h1 = onehot_row(i1, tig);
    // this lane's ldmatrix row: matrix m = lane / 8 is n-tile m / 2, words
    // 4 (m % 2) .. + 3 of the k-step; row lane % 8
    const int m = lane >> 3;
    const uint32_t ld_row = static_cast<uint32_t>(__cvta_generic_to_shared(
        bt + ((m >> 1) * 8 + (lane & 7)) * stride + (m & 1) * 4));
    int acc[MMA_TILES][4];
#pragma unroll
    for (int t = 0; t < MMA_TILES; t++)
#pragma unroll
        for (int e = 0; e < 4; e++) acc[t][e] = 0;
#pragma unroll
    for (int c = 0; c < MMA_MAX_CHUNKS; c++) {
        if (c >= chunks) break;
        const int k4 = c * (MMA_CHUNK / 4) + k4_first;
        if (k4 < k_rows / 4) {
            uint32_t any = 0;
#pragma unroll
            for (int r = 0; r < 4; r++)
                any |= v[c][r].x | v[c][r].y | v[c][r].z | v[c][r].w;
            if (any > 0xFFu) __trap();
#pragma unroll
            for (int j = 0; j < 4; j++)
                bt[(4 * quad + j) * stride + k4] =
                    word(v[c][0], j) | word(v[c][1], j) << 8 |
                    word(v[c][2], j) << 16 | word(v[c][3], j) << 24;
        }
        if (c + 1 < MMA_MAX_CHUNKS && c + 1 < chunks)
            load(c + 1, v[c + 1]);
        __syncthreads();
        const int s_end = min(k_rows, (c + 1) * MMA_CHUNK) / 32;
#pragma unroll 4  // k-steps a loop turn: their ldmatrix reads in flight
        for (int s = c * MMA_CHUNK / 32; s < s_end; s++) {
            const uint32_t a0 = s == h0.ks ? h0.lo : 0u;
            const uint32_t a2 = s == h0.ks ? h0.hi : 0u;
            const uint32_t a1 = s == h1.ks ? h1.lo : 0u;
            const uint32_t a3 = s == h1.ks ? h1.hi : 0u;
#pragma unroll
            for (int t2 = 0; t2 < MMA_TILES / 2; t2++) {
                uint32_t b[4];
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                    "{%0, %1, %2, %3}, [%4];"
                    : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                    : "r"(ld_row + (t2 * 16 * stride + s * 8) * 4));
#pragma unroll
                for (int h = 0; h < 2; h++) {
                    int (&d)[4] = acc[2 * t2 + h];
                    asm volatile(
                        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
                        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                        "{%0, %1, %2, %3};"
                        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
                        : "r"(a0), "r"(a1), "r"(a2), "r"(a3),
                          "r"(b[2 * h]), "r"(b[2 * h + 1]));
                }
            }
        }
    }
#pragma unroll
    for (int t = 0; t < MMA_TILES; t++) {
        const int col = blockIdx.y * MMA_COLS + t * 8 + tig * 2;
        if (r0 < n)
            __stcs(reinterpret_cast<int2 *>(out + r0 * N_COLS + col),
                   make_int2(acc[t][0], acc[t][1]));
        if (r1 < n)
            __stcs(reinterpret_cast<int2 *>(out + r1 * N_COLS + col),
                   make_int2(acc[t][2], acc[t][3]));
    }
}

// ---- v_take_lanes: gather across the words of a row, by shuffles ----------

constexpr int LANE_WARPS = 8;

__device__ __forceinline__ uint32_t lane_word(uint4 t, int i) {
    if (i < 0 || i >= 128) __trap();
    const int src = i >> 2;
    const uint32_t a = __shfl_sync(FULL, t.x, src);
    const uint32_t b = __shfl_sync(FULL, t.y, src);
    const uint32_t c = __shfl_sync(FULL, t.z, src);
    const uint32_t d = __shfl_sync(FULL, t.w, src);
    const int w = i & 3;
    return w == 0 ? a : w == 1 ? b : w == 2 ? c : d;
}

__global__ void __launch_bounds__(LANE_WARPS * 32) take_lanes_kernel(
        const int4 *__restrict__ idx, const uint4 *__restrict__ tab,
        long n_rows, uint4 *__restrict__ out) {
    const long row = (long)blockIdx.x * LANE_WARPS + (threadIdx.x >> 5);
    if (row >= n_rows) return;  // whole warps leave together
    const int lane = threadIdx.x & 31;
    const uint4 t = __ldcs(tab + row * 32 + lane);
    const int4 ix = __ldcs(idx + row * 32 + lane);
    __stcs(out + row * 32 + lane,
           make_uint4(lane_word(t, ix.x), lane_word(t, ix.y),
                      lane_word(t, ix.z), lane_word(t, ix.w)));
}

}  // namespace

// tab: (rows, 128) 32-bit words, 16-byte aligned.  Streams the first
// rows / chunk_rows * chunk_rows rows reps times, one block on every SM,
// one issuing thread with two slots of copy_rows rows (copy_rows divides
// chunk_rows).
extern "C" int skt_sweep_bw(const void *tab, long rows, int chunk_rows,
                            int reps, int copy_rows, void *out,
                            void *stream) {
    if (chunk_rows < 1 || copy_rows < 1 || chunk_rows % copy_rows ||
        reps < 0)
        return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    Ring r{(const unsigned char *)tab, 512, nullptr,
           reps * (rows / chunk_rows), chunk_rows, rows / chunk_rows,
           rows - chunk_rows, copy_rows, 1, 2};
    static DeviceBits smem_set;
    return launch_ring(sweep_kernel, smem_set, r, sms, out,
                       (cudaStream_t)stream);
}

// tab: (rows, 4) 32-bit words; idx: n row indices in [0, rows).  One
// 16-byte copy per index, q in flight (a power of two up to 128), from
// one warp: min(q, 32) lanes, q / 32 steps.
extern "C" int skt_row_dma_gather(const void *tab, long rows,
                                  const void *idx, long n, int q, void *out,
                                  void *stream) {
    if (q < 1 || q > 128 || (q & (q - 1))) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int lanes = q < 32 ? q : 32;
    switch (q / lanes) {
        case 1: return launch_row_ring<1>(tab, rows, idx, n, lanes, out, st);
        case 2: return launch_row_ring<2>(tab, rows, idx, n, lanes, out, st);
        default: return launch_row_ring<4>(tab, rows, idx, n, lanes, out,
                                           st);
    }
}

// tab: (rows, 128) 32-bit words; starts: n start rows in [0, rows - rpd].
// One copy of rpd rows per start, as pieces of piece_rows rows, from
// `issuers` threads of one block, each with one slot: as many copies in
// flight.
extern "C" int skt_block_dma_gather(const void *tab, long rows,
                                    const void *starts, long n, int rpd,
                                    int piece_rows, int issuers, void *out,
                                    void *stream) {
    Ring r{(const unsigned char *)tab, 512, (const int *)starts, n, rpd, 1,
           rows - rpd, piece_rows, issuers, 1};
    static DeviceBits smem_set;
    return launch_ring(block_gather_kernel, smem_set, r, 1, out,
                       (cudaStream_t)stream);
}

// tab: (rows, 128) 32-bit words, 16-byte aligned; idx: n row indices;
// out: (n, 128).  A warp a row, at most one wave of warps (2048 threads
// an SM).
extern "C" int skt_v_take_axis0(const void *tab, long rows, const void *idx,
                                long n, void *out, void *stream) {
    if (n <= 0 || rows <= 0) return (int)cudaGetLastError();
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    const long need = (n + TAKE_WARPS - 1) / TAKE_WARPS;
    const long wave = (long)sms * (2048 / TAKE_THREADS);
    const long blocks = need < wave ? need : wave;
    take_rows_kernel<<<(unsigned)blocks, TAKE_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const uint4 *)tab, rows, (const int *)idx, n, (uint4 *)out);
    return (int)cudaGetLastError();
}

// small: (k_rows, 128) 32-bit words of at most 8 bits, 16-byte aligned,
// k_rows a multiple of 32 up to 1024; idx: n row indices in [0, k_rows);
// out: (n, 128) int32.  Blocks of MMA_ROWS rows x MMA_COLS columns; the
// packed slice (at most 16,640 bytes) needs no raised limit.
extern "C" int skt_v_onehot_mxu(const void *small, int k_rows,
                                const void *idx, long n, void *out,
                                void *stream) {
    if (k_rows < 32 || k_rows % 32 || k_rows > MMA_MAX_CHUNKS * MMA_CHUNK)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    const int smem = MMA_COLS * packed_stride(k_rows) * 4;
    const dim3 grid((unsigned)((n + MMA_ROWS - 1) / MMA_ROWS),
                    N_COLS / MMA_COLS);
    onehot_kernel<<<grid, MMA_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint4 *)small, k_rows, (const int *)idx, n, (int *)out);
    return (int)cudaGetLastError();
}

// idx, tab, out: (n_rows, 128) 32-bit words, 16-byte aligned; idx in
// [0, 128).
extern "C" int skt_v_take_lanes(const void *idx, const void *tab,
                                long n_rows, void *out, void *stream) {
    if (n_rows > 0)
        take_lanes_kernel<<<(unsigned)((n_rows + LANE_WARPS - 1) /
                                       LANE_WARPS),
                            LANE_WARPS * 32, 0, (cudaStream_t)stream>>>(
            (const int4 *)idx, (const uint4 *)tab, n_rows, (uint4 *)out);
    return (int)cudaGetLastError();
}
