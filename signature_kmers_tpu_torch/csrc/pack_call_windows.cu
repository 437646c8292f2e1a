// Rolling 8-mer pack + call-side ambiguity mask, read straight from the
// query transfer rows: one thread per group of 16 windows.
//
// Replaces the JAX package's Pallas kernel ops/pallas_pack.py:
// pack_call_windows_pallas (body _kernel) together with the device expand
// that feeds it, ops/kmer_pack.py: expand_rows16 (the JAX caller fuses the
// two inside one jit; here the (B, L) code matrix never exists).
//
// The transfer-row reader (windows16.cuh) forms each window's (hi, lo,
// valid) in registers; the fused probes in probe_wide.cu use the same
// reader and never write these words.
//
// Bound on the H100: bytes.  It reads 12 bytes per transfer row that the
// windows cover and 8 bytes per sequence, and writes 9 bytes per window
// (two int32 words and a mask byte): ~24.3 MB, 7.3 us at 3.35 TB/s, for a
// uniform chunk of 8192 x 304 windows.  Design: thread (b, g) takes
// windows 16g..16g+15 of sequence b, whose 24 codes lie in rows g and
// g+1, so it loads five words (neighbouring threads take neighbouring
// rows, and a warp's loads fall in a few lines), sets the bits of the
// codes past the length, and cuts every 24-bit word out of the 160-bit
// stream with one funnel shift.  Group (b, g) is output group
// b * W/16 + g, the thread's own index, so a warp's 32 groups are 2 KB
// of hi and 2 KB of lo end to end.  A thread's own 64 bytes, stored as
// four 16-byte vectors, would give each warp store 32 pieces 64 bytes
// apart, twice the L2 sectors of the bytes, and measured over 2x slower
// on the H100; so each warp stages its hi, then its lo, through 2 KB of
// shared memory and stores them as 16-byte vectors that cover 512
// contiguous bytes per instruction.  The mask bytes are 16 contiguous
// bytes per thread and go straight out.  All stores are plain: the probe
// reads hi, lo and valid next, and a chunk's ~22 MB of them fit the 50 MB
// L2 (evict-first stores measured no faster).

#include <cstdint>
#include <cuda_runtime.h>

#include "windows16.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) pack_call_windows_rows16_kernel(
        const uint32_t *__restrict__ rows, int R,
        const int32_t *__restrict__ start_row,
        const int32_t *__restrict__ lengths, int L, unsigned G,
        unsigned n_groups, int4 *__restrict__ hi, int4 *__restrict__ lo,
        uint4 *__restrict__ valid) {
    // one warp's 32 groups of hi (then of lo), staged (windows16.cuh)
    __shared__ int4 stage[THREADS / 32][128];
    const unsigned t = blockIdx.x * THREADS + threadIdx.x;
    const unsigned lane = threadIdx.x & 31;
    // a lane past the last group still takes part in its warp's staging
    const bool active = t < n_groups;
    uint32_t s[5] = {0u, 0u, 0u, 0u, 0u}, vbits = 0u;
    bool tail = false;
    if (active) {
        const unsigned b = t / G;
        const int g = (int)(t - b * G);
        vbits = windows16::read_group(rows, R, (long)start_row[b] + g, g,
                                      lengths[b], L, s, tail);
    }

    int4 *w = stage[threadIdx.x >> 5];
    const size_t base = ((size_t)t - lane) * 4, end = (size_t)n_groups * 4;
#pragma unroll
    for (int pass = 0; pass < 2; pass++) {
#pragma unroll
        for (int k = 0; k < 4; k++) {
            uint32_t x[4];
#pragma unroll
            for (int j = 0; j < 4; j++)
                x[j] = pass ? windows16::window_lo(s, tail, 4 * k + j)
                            : windows16::window_hi(s, tail, 4 * k + j);
            windows16::stage_put(w, lane, k,
                                 make_int4((int)x[0], (int)x[1], (int)x[2],
                                           (int)x[3]));
        }
        __syncwarp();
        windows16::stage_flush(w, lane, base, end, pass ? lo : hi);
        __syncwarp();
    }
    // window i's mask byte is bit i of vbits
    if (active) valid[t] = windows16::bits_to_bytes(vbits);
}

}  // namespace

extern "C" int skt_pack_call_windows_rows16(
        const void *packed_rows, int R, const void *start_row,
        const void *lengths, int B, int L, int W, void *hi, void *lo,
        void *valid, void *stream) {
    const long n = (long)B * (W / 16);
    if (n > 0) {
        pack_call_windows_rows16_kernel<<<(unsigned)((n + THREADS - 1) /
                                                     THREADS),
                                          THREADS, 0,
                                          (cudaStream_t)stream>>>(
            (const uint32_t *)packed_rows, R, (const int32_t *)start_row,
            (const int32_t *)lengths, L, (unsigned)(W / 16), (unsigned)n,
            (int4 *)hi, (int4 *)lo, (uint4 *)valid);
    }
    return (int)cudaGetLastError();
}
