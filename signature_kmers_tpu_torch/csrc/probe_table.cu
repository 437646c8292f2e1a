// Linear-probing lookup in an open-addressing table (the legacy "skt-v1"
// layout, one shard of parallel/sharded_table.ShardedKmerTable).
//
// Replaces the XLA program the JAX package builds from ops/probe.py:
// probe_table (line 26), with ops/hashing.py: hash_kmer.  It computes
// what that program computes, not its lock step: the JAX program gathers
// one slot per query per round for the whole batch until every query is
// resolved; here each thread walks its own query's chain.
//
// Table: five uint32 arrays of S slots (S a power of two), key_hi,
// key_lo, v0, v1, v2; an empty slot holds key_hi = key_lo = 0xFFFFFFFF.
// A key sits in the first free slot at or after
//   h = fmix32(hi ^ (fmix32(lo) + 0x9E3779B9)) & (S - 1),
// and no chain is longer than max_probes slots (the build's round count).
// Per query (qhi, qlo), walking slots h, h+1, ... (mod S), at most
// max(max_probes, 1) of them:
//   a slot whose (key_hi, key_lo) equals the query is a hit: found = 1,
//     r0..r2 = the slot's v0..v2;
//   else an empty slot (key_hi = 0xFFFFFFFF) ends the walk: found = 0,
//     r0..r2 = 0;
// and a walk that reaches max_probes slots ends as a miss.  A hit is
// tested before emptiness, as in the JAX program, so a query of two
// 0xFFFFFFFF words "hits" the first empty slot with zero values there
// too (no 24-bit key is such a query).
//
// Bound on the H100: random reads.  A query reads key_hi at each slot it
// walks (a chain is short at load <= 0.6; consecutive slots share a
// 32-byte sector), key_lo only where key_hi equals the query's, and the
// three value words once on a hit: 2 + 3 sectors for a member found in
// its first slot, one for an alien that meets an empty slot.  The
// streaming part is 8 bytes in and 13 out per query.  Design: one thread
// per query, coalesced stream loads and stores; the table words go
// through the read-only path (__ldg).  A simple kernel: no attempt yet
// to keep several reads of one thread in flight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__global__ void probe_table_kernel(
        const uint32_t *__restrict__ key_hi,
        const uint32_t *__restrict__ key_lo,
        const uint32_t *__restrict__ v0, const uint32_t *__restrict__ v1,
        const uint32_t *__restrict__ v2, uint32_t mask,
        const uint32_t *__restrict__ qhi, const uint32_t *__restrict__ qlo,
        long n, int rounds, uint8_t *__restrict__ found,
        uint32_t *__restrict__ r0, uint32_t *__restrict__ r1,
        uint32_t *__restrict__ r2) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t hi = qhi[i], lo = qlo[i];
    uint32_t cur = fmix32(hi ^ (fmix32(lo) + GOLDEN)) & mask;
    uint8_t f = 0;
    uint32_t a = 0, b = 0, c = 0;
    for (int p = 0; p < rounds; p++) {
        const uint32_t kh = __ldg(key_hi + cur);
        if (kh == hi && __ldg(key_lo + cur) == lo) {
            f = 1;
            a = __ldg(v0 + cur);
            b = __ldg(v1 + cur);
            c = __ldg(v2 + cur);
            break;
        }
        if (kh == EMPTY) break;
        cur = (cur + 1u) & mask;
    }
    found[i] = f;
    r0[i] = a;
    r1[i] = b;
    r2[i] = c;
}

}  // namespace

// size: the slot count S (a power of two); n: the query count.  Returns
// cudaErrorInvalidValue without launching for a size that is not a power
// of two or does not fit 32 bits.
extern "C" int skt_probe_table(const void *key_hi, const void *key_lo,
                               const void *v0, const void *v1,
                               const void *v2, long size, const void *qhi,
                               const void *qlo, long n, int max_probes,
                               void *found, void *r0, void *r1, void *r2,
                               void *stream) {
    if (size <= 0 || (size & (size - 1)) || size > (1l << 32))
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        probe_table_kernel<<<(unsigned)((n + THREADS - 1) / THREADS),
                             THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t *)key_hi, (const uint32_t *)key_lo,
            (const uint32_t *)v0, (const uint32_t *)v1,
            (const uint32_t *)v2, (uint32_t)(size - 1),
            (const uint32_t *)qhi, (const uint32_t *)qlo, n,
            max_probes > 1 ? max_probes : 1, (uint8_t *)found,
            (uint32_t *)r0, (uint32_t *)r1, (uint32_t *)r2);
    }
    return (int)cudaGetLastError();
}
