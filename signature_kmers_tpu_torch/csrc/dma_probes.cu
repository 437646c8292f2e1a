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
// Bounds on the H100.  The copy probes are bound by bytes (the sweep by
// the 3.35 TB/s of device memory; the gathers by the latency of a random
// read, one issuing context as on the TPU's one core).  The three gathers
// are bound by the bytes of their inputs and outputs.
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
// - v_take_axis0: the 4 MiB table does not fit a block's shared memory,
//   so block (p, s) loads panel p (panel_rows rows, at most 384: 192 KiB)
//   and writes the output rows of slice s whose index lies in it, a warp
//   per row (a ballot over 32 indices, then 16 bytes a lane);
// - v_onehot_mxu: mma.sync m16n8k32 u8 x u8 -> s32 on the tensor cores;
//   the one-hot rows are made in registers from the indices, the 8-bit
//   table is staged in shared memory transposed, four k in a word;
// - v_take_lanes: a warp per row, the row's 128 words in registers (4 a
//   lane); each output is fetched by __shfl_sync from lane idx >> 2, one
//   shuffle per register, and word idx & 3 selected.
// An index out of range, a start past the last whole block, or a table
// word of v_onehot_mxu above 8 bits stops the kernel (__trap): the next
// synchronisation raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int RING_THREADS = 128;  // a ring block: it loads the indices
constexpr unsigned FULL = 0xFFFFFFFFu;

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

int launch_ring(void (*kernel)(Ring, uint32_t *), const Ring &r, int grid,
                void *out, cudaStream_t stream) {
    const long slots_n = (long)r.issuers * r.depth;
    const long smem = bars_bytes((int)slots_n) + slots_n * r.piece_rows *
        r.row_bytes + (r.starts ? r.n_copies * 4 : 0);
    if (r.depth < 1 || r.issuers < 1 || r.issuers > RING_THREADS ||
        r.piece_rows < 1 || r.rows_per_copy < 1 || smem > SMEM_MAX ||
        (r.piece_rows * (long)r.row_bytes) % 16)
        return (int)cudaErrorInvalidValue;
    if (r.n_copies <= 0) return (int)cudaGetLastError();
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
    cudaError_t e = cudaFuncSetAttribute(
        row_ring_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    row_ring_kernel<G><<<1, RING_THREADS, smem, stream>>>(
        (const uint4 *)tab, rows, (const int *)idx, n, lanes,
        (uint32_t *)out);
    return (int)cudaGetLastError();
}

// ---- v_take_axis0: row gather from a panel in shared memory ----------------

constexpr int TAKE_THREADS = 256;

__global__ void __launch_bounds__(TAKE_THREADS) take_rows_kernel(
        const uint4 *__restrict__ tab, long n_rows, int panel_rows,
        const int *__restrict__ idx, long n_out, long slice,
        uint4 *__restrict__ out) {
    extern __shared__ __align__(16) uint4 panel[];  // panel_rows x 32
    const long p0 = (long)blockIdx.x * panel_rows;
    const int rows = (int)min((long)panel_rows, n_rows - p0);
    for (int t = threadIdx.x; t < rows * 32; t += TAKE_THREADS)
        panel[t] = tab[p0 * 32 + t];
    __syncthreads();
    const long i0 = (long)blockIdx.y * slice;
    const long i1 = min(n_out, i0 + slice);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (long base = i0 + warp * 32; base < i1;
         base += TAKE_THREADS) {
        const long i = base + lane;
        long local = -1;
        if (i < i1) {
            const int row = idx[i];
            if (row < 0 || row >= n_rows) __trap();
            local = row - p0;
        }
        unsigned hit = __ballot_sync(FULL, local >= 0 && local < rows);
        while (hit) {
            const int b = __ffs(hit) - 1;
            hit &= hit - 1;
            const int lr = __shfl_sync(FULL, (int)local, b);
            out[(base + b) * 32 + lane] = panel[lr * 32 + lane];
        }
    }
}

// ---- v_onehot_mxu: one-hot product on the tensor cores ---------------------

constexpr int MMA_WARPS = 8;
constexpr int N_COLS = 128;        // the table's width
constexpr int B_STRIDE_PAD = 4;    // words of padding a transposed column

__device__ __forceinline__ uint32_t onehot4(int d) {
    // the 4 bytes of k = base..base+3 of a one-hot row whose 1 sits at
    // base + d
    return (d >= 0 && d < 4) ? 1u << (8 * d) : 0u;
}

// Warp w of block b: output rows 16 (b * MMA_WARPS + w) .. +15, all 128
// columns (16 tiles of 8), over k in steps of 32.
__global__ void __launch_bounds__(MMA_WARPS * 32) onehot_kernel(
        const uint32_t *__restrict__ small, int k_rows,
        const int *__restrict__ idx, long n, int *__restrict__ out) {
    extern __shared__ uint32_t bt[];  // [N_COLS][k_rows / 4 + pad]
    const int stride = k_rows / 4 + B_STRIDE_PAD;
    // each word's four loads issue before any is checked, and four words
    // a thread at once: the staging waits on few round trips to L2
#pragma unroll 4
    for (int t = threadIdx.x; t < N_COLS * (k_rows / 4);
         t += MMA_WARPS * 32) {
        const int col = t % N_COLS, k4 = t / N_COLS;
        const uint32_t *src = small + (long)4 * k4 * N_COLS + col;
        const uint32_t v0 = src[0], v1 = src[N_COLS];
        const uint32_t v2 = src[2 * N_COLS], v3 = src[3 * N_COLS];
        if ((v0 | v1 | v2 | v3) > 0xFFu) __trap();
        bt[col * stride + k4] = v0 | v1 << 8 | v2 << 16 | v3 << 24;
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const long r0 = ((long)blockIdx.x * MMA_WARPS + warp) * 16 + g;
    const long r1 = r0 + 8;
    int i0 = -1000, i1 = -1000;  // rows past n: no 1 anywhere
    if (r0 < n) i0 = idx[r0];
    if (r1 < n) i1 = idx[r1];
    if ((r0 < n && (i0 < 0 || i0 >= k_rows)) ||
        (r1 < n && (i1 < 0 || i1 >= k_rows)))
        __trap();
    int acc[16][4];
#pragma unroll
    for (int t = 0; t < 16; t++)
#pragma unroll
        for (int c = 0; c < 4; c++) acc[t][c] = 0;
    for (int kb = 0; kb < k_rows; kb += 32) {
        const int c = kb + tig * 4;
        const uint32_t a0 = onehot4(i0 - c), a1 = onehot4(i1 - c);
        const uint32_t a2 = onehot4(i0 - c - 16), a3 = onehot4(i1 - c - 16);
#pragma unroll
        for (int t = 0; t < 16; t++) {
            const uint32_t *col = bt + (t * 8 + g) * stride + kb / 4;
            const uint32_t b0 = col[tig], b1 = col[4 + tig];
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};"
                : "+r"(acc[t][0]), "+r"(acc[t][1]), "+r"(acc[t][2]),
                  "+r"(acc[t][3])
                : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
    }
#pragma unroll
    for (int t = 0; t < 16; t++) {
        const int col = t * 8 + tig * 2;
        if (r0 < n)
            *reinterpret_cast<int2 *>(out + r0 * N_COLS + col) =
                make_int2(acc[t][0], acc[t][1]);
        if (r1 < n)
            *reinterpret_cast<int2 *>(out + r1 * N_COLS + col) =
                make_int2(acc[t][2], acc[t][3]);
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

int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return 0;
    return n;
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
    return launch_ring(sweep_kernel, r, sms, out, (cudaStream_t)stream);
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
    return launch_ring(block_gather_kernel, r, 1, out,
                       (cudaStream_t)stream);
}

// tab: (rows, 128) 32-bit words; idx: n row indices; out: (n, 128).
// Panels of panel_rows rows (at most 384), each loaded by
// `slices` blocks, block (p, s) writing slice s's rows in panel p.
extern "C" int skt_v_take_axis0(const void *tab, long rows, const void *idx,
                                long n, int panel_rows, int slices,
                                void *out, void *stream) {
    const long smem = (long)panel_rows * 512;
    if (panel_rows < 1 || slices < 1 || smem > SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    if (n <= 0 || rows <= 0) return (int)cudaGetLastError();
    cudaError_t e = cudaFuncSetAttribute(
        take_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((rows + panel_rows - 1) / panel_rows),
                    (unsigned)slices);
    take_rows_kernel<<<grid, TAKE_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint4 *)tab, rows, panel_rows, (const int *)idx, n,
        (n + slices - 1) / slices, (uint4 *)out);
    return (int)cudaGetLastError();
}

// small: (k_rows, 128) 32-bit words of at most 8 bits, k_rows a multiple
// of 32; idx: n row indices in [0, k_rows); out: (n, 128) int32.
extern "C" int skt_v_onehot_mxu(const void *small, int k_rows,
                                const void *idx, long n, void *out,
                                void *stream) {
    const long smem = (long)N_COLS * (k_rows / 4 + B_STRIDE_PAD) * 4;
    if (k_rows < 32 || k_rows % 32 || smem > SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaError_t e = cudaFuncSetAttribute(
        onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long rows_a_block = MMA_WARPS * 16;
    onehot_kernel<<<(unsigned)((n + rows_a_block - 1) / rows_a_block),
                    MMA_WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const uint32_t *)small, k_rows, (const int *)idx, n, (int *)out);
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
