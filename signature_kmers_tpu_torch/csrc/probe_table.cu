// Linear-probing lookup in an open-addressing table (the legacy "skt-v1"
// layout, one shard of parallel/sharded_table.ShardedKmerTable): kernel L2.
//
// Replaces the XLA program the JAX package builds from ops/probe.py:
// probe_table (line 26), with ops/hashing.py: hash_kmer.  It computes
// what that program computes, not its lock step: the JAX program gathers
// one slot per query per round for the whole batch until every query is
// resolved; here each thread walks its own query's chain.
//
// Table on the device (ops/probe.linear_rows, built once at upload): S
// slots, S a power of two that fits 32 bits, as two row arrays:
//   keys (S, 2) = (key_hi, key_lo) per slot: 8 bytes, four slots to a
//        32-byte sector;
//   vals (S, 4) = (v0, v1, v2, 0) per slot: 16 bytes inside one sector.
// An empty slot holds key_hi = key_lo = 0xFFFFFFFF.  A key sits in the
// first free slot at or after
//   h = fmix32(hi ^ (fmix32(lo) + 0x9E3779B9)) & (S - 1),
// and no chain is longer than max_probes slots (the build's round count).
// Per query (qhi, qlo), walking slots h, h+1, ... (slot S-1 is followed by
// slot 0), at most max(max_probes, 1) of them:
//   a slot whose (key_hi, key_lo) equals the query is a hit: found = 1,
//     r0..r2 = the slot's v0..v2;
//   else an empty slot (key_hi = 0xFFFFFFFF) ends the walk: found = 0,
//     r0..r2 = 0;
// and a walk that reaches max_probes slots ends as a miss.  A hit is
// tested before emptiness, as in the JAX program, so a query of two
// 0xFFFFFFFF words "hits" the first empty slot with the zero values there
// (no 24-bit key is such a query).
//
// Bound on the H100: random reads.  A walk reads the key row of each
// slot it visits; neighbouring slots share a sector, so at load 0.6 a
// member's walk touches ~1.2 key sectors and an alien's ~1.6, and a hit
// reads one value row.  The streaming part is 8 bytes in and 13 out per
// query.  The card serves such reads at ~30 G sectors/s at most
// (kernels 8-9), far below its 3.35 TB/s in whole sectors, so the time
// goes with the count of sectors requested, and with the round trips
// that nothing else in flight hides.  The first design (a thread per
// query over five word arrays) requested key_hi, then key_lo, then three
// value words, up to five sectors in three dependent round trips.
// Design:
// - one query a thread, its words read and its outputs written in 4-byte
//   accesses that a warp coalesces into whole 128-byte lines
//   (evict-first);
// - each walk step one 8-byte load of the slot's key row, through the
//   read-only cache, so a next slot in the same sector is served by L1;
// - on a hit one 16-byte evict-first load of the value row.
// Two alternatives measured slower at both of chip_smoke.py's shapes
// (PERF.md has their times): four walks a thread, stepping together,
// which waits for the thread's longest walk while the card's resident
// threads already keep enough reads in flight; and four lanes a query,
// a ballot over the walk's aligned sector, which takes four times the
// threads for the same sectors.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
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

// Query t of thread t: its walk from its home slot, at most `rounds`
// slots, then its value row on a hit.
__global__ void __launch_bounds__(THREADS) probe_walks_kernel(
        const uint2 *__restrict__ keys, const uint4 *__restrict__ vals,
        uint32_t mask, const uint32_t *__restrict__ qhi,
        const uint32_t *__restrict__ qlo, long n, int rounds,
        uint8_t *__restrict__ found, uint32_t *__restrict__ r0,
        uint32_t *__restrict__ r1, uint32_t *__restrict__ r2) {
    const long t = (long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= n) return;
    const uint32_t h = __ldcs(qhi + t), l = __ldcs(qlo + t);
    uint32_t cur = fmix32(h ^ (fmix32(l) + GOLDEN)) & mask;
    bool hit = false;
    for (int p = 0; p < rounds; p++) {
        const uint2 k = __ldg(keys + cur);
        if (k.x == h && k.y == l) {
            hit = true;
            break;
        }
        if (k.x == EMPTY) break;
        cur = (cur + 1u) & mask;
    }
    const uint4 v = hit ? __ldcs(vals + cur) : make_uint4(0u, 0u, 0u, 0u);
    found[t] = hit;
    __stcs(r0 + t, v.x);
    __stcs(r1 + t, v.y);
    __stcs(r2 + t, v.z);
}

}  // namespace

// size: the slot count S (a power of two); n: the query count.  keys
// 8-byte and vals 16-byte aligned (the wrapper checks them).  Returns
// cudaErrorInvalidValue without launching for a size that is not a power
// of two or does not fit 32 bits; else cudaGetLastError().
extern "C" int skt_probe_table(const void *keys, const void *vals, long size,
                               const void *qhi, const void *qlo, long n,
                               int max_probes, void *found, void *r0,
                               void *r1, void *r2, void *stream) {
    if (size <= 0 || (size & (size - 1)) || size > (1l << 32))
        return (int)cudaErrorInvalidValue;
    if (n > 0)
        probe_walks_kernel<<<(unsigned)((n + THREADS - 1) / THREADS),
                             THREADS, 0, (cudaStream_t)stream>>>(
            (const uint2 *)keys, (const uint4 *)vals, (uint32_t)(size - 1),
            (const uint32_t *)qhi, (const uint32_t *)qlo, n,
            max_probes > 1 ? max_probes : 1, (uint8_t *)found,
            (uint32_t *)r0, (uint32_t *)r1, (uint32_t *)r2);
    return (int)cudaGetLastError();
}
