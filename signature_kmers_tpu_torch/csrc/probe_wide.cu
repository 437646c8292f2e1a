// Wide tagged-bucket probe, one thread per window.
//
// Replaces the XLA program the JAX package builds from ops/probe.py:
// probe_wide + _tagged_match (lines 141-192), with ops/hashing.py: perm48
// and wide_bucket_tag, for the no-aux case the caller runs.
//
// Per window: a 3-round Feistel permutation of the 48-bit key (hi, lo) is
// split into (bucket, tag); the thread reads the main row
// packed[bucket] = [tag x slots | fm x slots] and matches the tag.  When
// the build has overflow keys it repeats the lookup in the overflow leaf
// with the leaf's salt and bits, for the windows the main row missed.
// Outputs:
//   fm    = fm of the matching slot (main first, then leaf; 0 on a miss),
//           and 0 where valid is false (the caller reads fm only where
//           found, so it is compared with the plain version under valid),
//   found = (main or leaf match) & valid & (fm>>16 != ignore_function).
// ignore_function is -1 when hypothetical proteins are not ignored.
//
// Bound on the H100: bytes, and those are random reads.  Each valid
// window touches one 32-byte DRAM sector of the main table (16 B rows at
// 2 slots, 32 B at 4); an invalid window reads no table row.  A valid
// window that missed the main row also reads the overflow leaf, which the
// build sizes to 32 MB or less where it can, so that it stays in the
// 50 MB L2.  The streaming
// part (hi, lo, valid in; found, fm out) is 14 bytes per window.  Design:
// the hash is a few dozen integer
// operations, far below the memory time, so one thread per window keeps
// as many independent row reads in flight as the SMs hold threads; no
// shared memory, because no two windows share a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M24 = 0xFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// One tagged-store lookup: returns whether the tag matched and the masked
// sum of the matching slots' fm words (tags are unique within a bucket).
__device__ __forceinline__ bool tagged_match(
        const uint32_t *__restrict__ packed, int slots, uint32_t salt,
        int bits, uint32_t hi, uint32_t lo, uint32_t &fm) {
    const uint32_t rc[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};
    uint32_t L = hi & M24, R = lo & M24;
    for (int r = 0; r < 3; r++) {
        uint32_t F = fmix32(R ^ (salt ^ rc[r])) & M24;
        uint32_t t = L ^ F;
        L = R;
        R = t;
    }
    uint32_t bucket, tag;
    if (bits <= 24) {
        bucket = R & ((1u << bits) - 1u);
        tag = (L << (24 - bits)) | (R >> bits);
    } else {
        bucket = ((L & ((1u << (bits - 24)) - 1u)) << 24) | R;
        tag = L >> (bits - 24);
    }
    const uint32_t *row = packed + (size_t)bucket * 2 * slots;
    bool f = false;
    fm = 0u;
    for (int s = 0; s < slots; s++) {
        if (row[s] == tag) {
            f = true;
            fm += row[slots + s];
        }
    }
    return f;
}

__global__ void probe_wide_kernel(
        const uint32_t *__restrict__ hi, const uint32_t *__restrict__ lo,
        const uint8_t *__restrict__ valid, long n,
        const uint32_t *__restrict__ packed, int slots, uint32_t salt,
        int bits, const uint32_t *__restrict__ ov_packed, int ov_slots,
        uint32_t ov_salt, int ov_bits, int has_overflow, int ignore_function,
        uint8_t *__restrict__ found, uint32_t *__restrict__ fm_out) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!valid[i]) {  // no table read: found is false, fm is not used
        found[i] = 0;
        fm_out[i] = 0u;
        return;
    }
    uint32_t h = hi[i], l = lo[i], fm1, fm2 = 0u;
    bool f = tagged_match(packed, slots, salt, bits, h, l, fm1);
    bool f2 = !f && has_overflow
        && tagged_match(ov_packed, ov_slots, ov_salt, ov_bits, h, l, fm2);
    uint32_t fm = f ? fm1 : fm2;
    found[i] = (f || f2) && (int)(fm >> 16) != ignore_function;
    fm_out[i] = fm;
}

}  // namespace

extern "C" int skt_probe_wide(const void *hi, const void *lo,
                              const void *valid, long n, const void *packed,
                              int slots, unsigned salt, int bits,
                              const void *ov_packed, int ov_slots,
                              unsigned ov_salt, int ov_bits, int has_overflow,
                              int ignore_function, void *found, void *fm,
                              void *stream) {
    if (n > 0) {
        int threads = 256;
        long blocks = (n + threads - 1) / threads;
        probe_wide_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
            (const uint32_t *)hi, (const uint32_t *)lo,
            (const uint8_t *)valid, n, (const uint32_t *)packed, slots, salt,
            bits, (const uint32_t *)ov_packed, ov_slots, ov_salt, ov_bits,
            has_overflow, ignore_function, (uint8_t *)found, (uint32_t *)fm);
    }
    return (int)cudaGetLastError();
}
