// Rolling 8-mer pack + call-side ambiguity mask, one thread per window.
//
// Replaces the JAX package's Pallas kernel ops/pallas_pack.py:
// pack_call_windows_pallas (body _kernel) and its XLA twin
// ops/kmer_pack.py: pack_call_windows, which the fused caller runs.
//
// For window p of row b (codes are 6-bit, padded with INVALID = 63):
//   hi    = c[p]<<18 | c[p+1]<<12 | c[p+2]<<6 | c[p+3]      (24 bits)
//   lo    = c[p+4]<<18 | ... | c[p+7]                       (24 bits)
//   valid = no '*' (52) or uppercase 'X' (23) in c[p..p+8] (c[p+8] only
//           when p+8 < L) and p+8 <= length.
// Past the row end the words take the XLA program's shift fills (INVALID
// for the first code shift, 0 for the word shifts), so hi and lo are
// defined everywhere and equal the plain version bit for bit.
//
// Bound on the H100: bytes.  It reads B*L code bytes and writes 9 bytes
// per kept window (two int32 words and one mask byte), with a handful of
// integer operations per window.  Design: neighbouring threads take
// neighbouring windows of one row, so the nine overlapping code reads of
// a warp fall in the same one or two cache lines and every store is
// coalesced; only the first W <= L windows are written, the width the
// probe keeps, so padding windows never reach device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 8;
constexpr uint32_t INVALID = 63, STAR = 52, X_UPPER = 23, M24 = 0xFFFFFFu;

__device__ __forceinline__ uint32_t d2(const uint8_t *row, int j, int L) {
    if (j >= L) return 0u;
    uint32_t next = j + 1 < L ? row[j + 1] : INVALID;
    return ((uint32_t)row[j] << 6) | next;
}

__device__ __forceinline__ uint32_t d4(const uint8_t *row, int j, int L) {
    if (j >= L) return 0u;
    return (d2(row, j, L) << 12) | d2(row, j + 2, L);
}

__device__ __forceinline__ bool ok(uint8_t c) {
    return c != STAR && c != X_UPPER;
}

__global__ void pack_call_windows_kernel(
        const uint8_t *__restrict__ codes, const int32_t *__restrict__ lengths,
        int B, int L, int W, uint32_t *__restrict__ hi,
        uint32_t *__restrict__ lo, uint8_t *__restrict__ valid) {
    long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long)B * W) return;
    int b = (int)(idx / W), p = (int)(idx % W);
    const uint8_t *row = codes + (long)b * L;
    hi[idx] = d4(row, p, L) & M24;
    lo[idx] = d4(row, p + 4, L) & M24;
    bool v = p + K <= lengths[b];
    for (int i = 0; i < K; i++) v = v && p + i < L && ok(row[p + i]);
    if (p + K < L) v = v && ok(row[p + K]);
    valid[idx] = v;
}

}  // namespace

extern "C" int skt_pack_call_windows(const void *codes, const void *lengths,
                                     int B, int L, int W, void *hi, void *lo,
                                     void *valid, void *stream) {
    long n = (long)B * W;
    if (n > 0) {
        int threads = 256;
        long blocks = (n + threads - 1) / threads;
        pack_call_windows_kernel<<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
            (const uint8_t *)codes, (const int32_t *)lengths, B, L, W,
            (uint32_t *)hi, (uint32_t *)lo, (uint8_t *)valid);
    }
    return (int)cudaGetLastError();
}
