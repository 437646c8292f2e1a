// Rolling 8-mer pack + call-side ambiguity mask, read straight from the
// query transfer rows: one thread per group of 16 windows.
//
// Replaces the JAX package's Pallas kernel ops/pallas_pack.py:
// pack_call_windows_pallas (body _kernel) together with the device expand
// that feeds it, ops/kmer_pack.py: expand_rows16 (the JAX caller fuses the
// two inside one jit; here the (B, L) code matrix never exists).
//
// Input: the host's transfer rows, 16 codes of 6 bits MSB-first in three
// uint32 words per row.  Code j of sequence b sits in row
// clamp(start_row[b] + j / 16, 0, R - 1) and reads INVALID (63) from
// position lengths[b] on.  For window p < W:
//   hi    = c[p]<<18 | c[p+1]<<12 | c[p+2]<<6 | c[p+3]      (24 bits)
//   lo    = c[p+4]<<18 | ... | c[p+7]                       (24 bits)
//   valid = no '*' (52) or uppercase 'X' (23) in c[p..p+8] (c[p+8] only
//           when p+8 < L) and p+8 <= length.
// Past L the words take the XLA program's shift fills (INVALID for the
// first code shift, 0 for the word shifts), so hi and lo are defined
// everywhere and equal the plain version bit for bit.
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

namespace {

constexpr int THREADS = 256;
constexpr uint32_t STAR = 52, X_UPPER = 23;

// 32 bits of the MSB-first stream s from bit o on.  o is a constant once
// the loops are unrolled, so this is one funnel shift, a shift or a move.
__device__ __forceinline__ uint32_t bits32(const uint32_t (&s)[5], int o) {
    const int q = o >> 5, r = o & 31;
    if (r == 0) return s[q];
    if (q == 4) return s[4] << r;
    return __funnelshift_l(s[q + 1], s[q], r);
}

// A word's bits from its MSB-first bit t on (all of them for t <= 0).
__device__ __forceinline__ uint32_t ones_from(int t) {
    return t <= 0 ? ~0u : t >= 32 ? 0u : ~0u >> t;
}

__global__ void __launch_bounds__(THREADS) pack_call_windows_rows16_kernel(
        const uint32_t *__restrict__ rows, int R,
        const int32_t *__restrict__ start_row,
        const int32_t *__restrict__ lengths, int L, unsigned G,
        unsigned n_groups, int4 *__restrict__ hi, int4 *__restrict__ lo,
        uint4 *__restrict__ valid) {
    // one warp's 32 groups of hi (then of lo), 16-byte slot (lane, k) at
    // lane * 4 + (k ^ (lane >> 1 & 3)): the 8 lanes of a 128-byte phase
    // write distinct banks, and 8 lanes reading 128 contiguous bytes too
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
        const int len = lengths[b];
        const long r = (long)start_row[b] + g;
        // only when W == L: positions from 16g + 16 on lie past L
        tail = 16 * (g + 1) >= L;
        const long r0 = r < 0 ? 0 : r > R - 1 ? R - 1 : r;
        s[0] = rows[3 * r0];
        s[1] = rows[3 * r0 + 1];
        s[2] = rows[3 * r0 + 2];
        if (!tail) {
            const long r1 = r + 1 < 0 ? 0 : r + 1 > R - 1 ? R - 1 : r + 1;
            s[3] = rows[3 * r1];
            s[4] = rows[3 * r1 + 1];
        }
        // codes from the sequence's length on read INVALID: set their bits
        const int cut = 6 * max(0, min(len - 16 * g, 24));
#pragma unroll
        for (int k = 0; k < 5; k++) s[k] |= ones_from(cut - 32 * k);
        if (tail) {
            // past L: the first code shift fills INVALID, the word shifts 0
            s[3] = 63u << 26;
            s[4] = 0u;
        }

        // bit i: code i of the 24 is '*' or 'X'
        uint32_t bad = 0;
#pragma unroll
        for (int i = 0; i < 24; i++) {
            const uint32_t c = bits32(s, 6 * i) >> 26;
            bad |= (uint32_t)(c == STAR || c == X_UPPER) << i;
        }
        // bit i: an ambiguous code among codes i..i+8
        uint32_t amb = bad | bad >> 1;
        amb |= amb >> 2;
        amb |= amb >> 4;
        amb |= bad >> 8;
        // windows with p + 8 <= min(length, L)
        const int n_in = max(0, min(min(len, L) - 16 * g - 7, 16));
        vbits = ~amb & ((1u << n_in) - 1u);
    }

    int4 *w = stage[threadIdx.x >> 5];
    const size_t base = ((size_t)t - lane) * 4, end = (size_t)n_groups * 4;
#pragma unroll
    for (int pass = 0; pass < 2; pass++) {
        int4 *out = pass ? lo : hi;
#pragma unroll
        for (int k = 0; k < 4; k++) {
            // hi of window i is the 24 bits from code i, lo from code i + 4
            uint32_t x[4];
#pragma unroll
            for (int j = 0; j < 4; j++)
                x[j] = bits32(s, 6 * (4 * k + j) + 24 * pass) >> 8;
            if (tail) {
                // the word shifts' 0 past L: window 14's hi and window
                // 10's lo keep two codes, and lo is 0 from window 12 on
                if (pass == 0 && k == 3) x[2] &= 0xFFF000u;
                if (pass == 1 && k == 2) x[2] &= 0xFFF000u;
                if (pass == 1 && k == 3) x[0] = x[1] = x[2] = x[3] = 0u;
            }
            w[lane * 4 + (k ^ (lane >> 1 & 3))] =
                make_int4((int)x[0], (int)x[1], (int)x[2], (int)x[3]);
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 4; k++) {
            const unsigned i = 32 * k + lane, src = i >> 2;
            if (base + i < end)
                out[base + i] = w[src * 4 + ((i & 3) ^ (src >> 1 & 3))];
        }
        __syncwarp();
    }
    if (active) {
        // window i's mask byte is bit i of vbits: 4 bits to 4 bytes by
        // one multiply each
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; k++)
            v[k] = ((vbits >> (4 * k)) & 15u) * 0x00204081u & 0x01010101u;
        valid[t] = make_uint4(v[0], v[1], v[2], v[3]);
    }
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
