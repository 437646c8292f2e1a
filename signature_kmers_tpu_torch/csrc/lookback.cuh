// Single-pass exclusive scan over tiles by decoupled look-back (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), shared by the build's two kernels.
//
// The wrapper zeroes a scratch array of 2 + n_tiles 64-bit words:
// scratch[0] hands out tile ids in the order blocks start (atomicAdd), so
// a tile only waits on tiles that are already running and the scan cannot
// deadlock however the blocks are scheduled; scratch[1] receives the last
// tile's inclusive total (the kernel's output size, read once by the
// host); scratch[2 + t] is tile t's status word, value << 2 | flag, with
// flag 0 (nothing yet), AGGREGATE (the tile's own count) or INCLUSIVE (the
// count of every tile up to and including it).  A status is one 64-bit
// store, so a reader never sees a flag without its value.

#pragma once

#include <cstdint>

namespace skt {

constexpr unsigned long long AGGREGATE = 1ull, INCLUSIVE = 2ull;

__device__ __forceinline__ unsigned long long load_relaxed(
        const unsigned long long *p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long *p,
                                              unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

// the calling block's tile id; every thread of the block must call it
// (it synchronises the block)
__device__ __forceinline__ long long take_tile(unsigned long long *scratch,
                                               long long *slot) {
    if (threadIdx.x == 0) *slot = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    return *slot;
}

// Called by one whole warp of tile `tile` with the tile's own count:
// publishes it, looks back over the tiles before it (32 at a time) and
// returns their total to every lane; publishes the tile's inclusive count,
// and the last tile writes it to scratch[1].
__device__ unsigned long long exclusive_prefix(unsigned long long *scratch,
                                               long long tile,
                                               long long n_tiles,
                                               unsigned long long count) {
    constexpr unsigned FULL = 0xFFFFFFFFu;
    const int lane = threadIdx.x & 31;
    unsigned long long *status = scratch + 2;
    unsigned long long before = 0;
    if (tile > 0) {
        if (lane == 0) store_relaxed(status + tile, (count << 2) | AGGREGATE);
        for (long long last = tile - 1;; last -= 32) {
            const long long t = last - lane;
            unsigned long long s;
            do {  // a tile before the first counts as an inclusive 0
                s = t >= 0 ? load_relaxed(status + t) : INCLUSIVE;
            } while (__any_sync(FULL, (s & 3ull) == 0));
            const unsigned inc = __ballot_sync(FULL, (s & 3ull) == INCLUSIVE);
            // add the tiles down to the nearest inclusive one
            const int stop = inc ? __ffs(inc) - 1 : 31;
            unsigned long long v = lane <= stop ? s >> 2 : 0;
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
            before += v;
            if (inc) break;
        }
    }
    if (lane == 0) {
        store_relaxed(status + tile, ((before + count) << 2) | INCLUSIVE);
        if (tile == n_tiles - 1) scratch[1] = before + count;
    }
    return before;
}

}  // namespace skt
