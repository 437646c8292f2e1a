// Build-side selection over the sorted windows: per k-mer group the 80%
// rule, the best function and its length statistics, packed into the four
// words of a kept signature; the kept words compacted in k-mer order, and
// a flag per sequence that has an entry in a kept group.
//
// Replaces the XLA programs of the JAX package's build after their sorts
// (models/signature_builder.py: _select_signatures_jax, lines 265-370, run
// extents by cummax/cummin and the best pair's sums by four-lane
// Hillis-Steele segmented scans, ops/segscan.py; _select_compact_jax,
// lines 373-423, the word packing, the cumsum compaction and the unique
// kept sequence ids; _finalize_stats_jax, lines 167-233, 32-bit limb
// arithmetic).  A group is a contiguous run of the sorted arrays, so it is
// read once and needs no scan; CUDA has 64-bit integers, so the statistics
// are _finalize_stats_np's int64 formulas (lines 38-59, the spec), and the
// TPU's 16-bit split channels and limb division are not carried over.
//
// Inputs: k1s, the sort-1 keys ((kmer48 << 16 | function) ^ (1 << 63))
// in ascending signed order, so each group is ordered by function and,
// through the prior stable sort, by protein length; plen_s, the lengths in
// that order; k2s, the sort-2 keys ((kmer48 << 16 | offset) ^ (1 << 63))
// sorted, whose groups lie at the same indices; seq_s, each entry's dense
// sequence index (< n_seqs) in sort-1 order.  Per group (entries gs..ge-1,
// ktotal = ge - gs):
// - function runs are contiguous and arrive in function order, so the best
//   run is the first of the largest count, which is the lowest function
//   index among ties (ref signature_build.tcc:228-248);
// - keep = !((float)best_count < (float)ktotal * threshold), in float32
//   (built with -fmad=false; ref signature_build.tcc:250-257);
// - over the best run: sum and sum of squares of the lengths (64-bit), the
//   lower and upper median by index, then mean, median and variance floors
//   truncated to 16 bits, bit for bit the int64 numpy spec (its
//   wrap-around included: products in unsigned 64-bit, floor division
//   signed);
// - avg_from_end = the offset at gs + ktotal / 2 of k2s (the upper median
//   of all offsets, ref signature_build.tcc:281-282);
// - word = (kmer48 >> 16, (kmer48 & 0xFFFF) << 16 | best function,
//   mean << 16 | median, var << 16 | avg_from_end).
// Outputs: words[0..n_kept) the kept groups' words in group order (which
// is ascending k-mer order), n_kept in scratch[1] (lookback.cuh), and
// flags[seq] = 1 for every entry of a kept group.  Every writer of a flag
// byte writes 1, so the flags need no atomics and are deterministic.
//
// Design.  A block takes a tile of TILE consecutive entries (tile ids in
// start order, lookback.cuh) and stages it, with a halo of SMALL entries
// past its end, into shared memory by 16-byte cp.async copies.  It owns
// the groups whose first entry lies in the tile, found in shared memory
// (the k-mer differs from the entry before), so no starts array is read,
// and a group of any size is walked exactly once.  A group of at most
// SMALL entries ends inside tile + halo and is walked by one thread from
// shared memory; a larger one (at most TILE / (SMALL + 1) + 1 start in a
// tile) goes to a list that the block's warps take in turn, each walking
// its group 32 entries at a time (ballots on the function and k-mer
// changes), from shared memory when the group ends inside tile + halo and
// from global memory otherwise.  The block then scans its kept flags in
// group order and publishes its kept count; while warp 0 looks back for
// the block's output offset (decoupled look-back), the warps set the kept
// groups' sequence flags (a byte store per entry, skipped where the byte
// already reads 1, the loads issued before the stores), which hides the
// look-back's wait; then the block writes its kept words at the offset:
// one kernel, no host round trip, an order that does not depend on
// scheduling.
//
// Bound on the H100: bytes, counted in the 32-byte sectors that hold an
// element the function needs.  It reads all of k1s (each group's extent
// and runs), plen_s over each kept group's best run, seq_s over each kept
// group, k2s at each kept group's middle entry only, and writes 16 bytes
// per kept group and one flag byte per sequence: 2.512 GB for the
// 300K-sequence corpus (87.9M entries, 45.1M kept groups; k1s 0.703,
// plen_s and seq_s 0.352 each, k2s 0.384, words 0.722), 0.750 ms at
// 3.35 TB/s.  Staging reads every plen_s, seq_s and k2s entry, the halo
// re-reads 3% of the entries, and a flag byte is a scattered store per
// entry of a kept group.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;           // 64 registers a thread
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;                 // entries a block owns
constexpr int SMALL = 32;                  // largest thread-walked group
constexpr int STAGE = TILE + SMALL;        // entries staged: tile + halo
constexpr int CHUNKS = STAGE / 32;         // 32-entry chunks of the stage
constexpr int PER_THREAD = TILE / THREADS;
constexpr int MAX_LARGE = TILE / (SMALL + 1) + 1;
constexpr unsigned short UNKNOWN = 0xFFFF;  // group end past the stage
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(STAGE % 32 == 0 && TILE % THREADS == 0, "tile shape");

struct Stage {
    long long k1[STAGE];
    long long k2[STAGE];
    int32_t pl[STAGE];
    int32_t sq[STAGE];
    unsigned mask[CHUNKS];          // group starts, a bit per entry
    int chunk_base[CHUNKS];
    unsigned short list[STAGE + 1];  // group starts, then the end
    uint4 large_word[MAX_LARGE];
    long long large_end[MAX_LARGE];  // from the tile's first entry
    int large_j[MAX_LARGE];
    uint8_t large_kept[MAX_LARGE];
    uint8_t kept[TILE];
    unsigned short koff[TILE];
    int warp_total[WARPS];
    int n_tile, n_large;
    long long tile;
    unsigned long long base;
};

struct Picked {  // a group's result
    uint4 word;
    bool kept;
    long long end;  // the group's end, found by a warp walk
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    return v;
}

// floor division of signed 64-bit integers (numpy's //), b > 0
__device__ __forceinline__ long long floor_div(long long a, long long b) {
    long long q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

__device__ __forceinline__ long long kmer_of(long long key) {
    return key >> 16;
}

// true when s indexes the flags; otherwise marks *bad for the wrapper,
// which raises, and the flag is neither loaded nor stored
__device__ __forceinline__ bool seq_ok(int32_t s, int n_seqs,
                                       unsigned long long *bad) {
    const bool ok = (unsigned)s < (unsigned)n_seqs;
    if (!ok) *bad = 1ull;
    return ok;
}

// the word of a group from its best run's count n, function, sums and
// medians, its first sort-1 key and its sort-2 key at gs + ktotal / 2
__device__ Picked finish(long long ktotal, long long n, int best_func,
                         unsigned long long s, unsigned long long sq,
                         long long ml, long long mh, long long first_key,
                         long long mid_k2, float threshold) {
    const unsigned long long un = (unsigned long long)n;
    const long long c = (long long)s / n;
    const unsigned long long uc = (unsigned long long)c;
    // d2 = sq - 2*c*s + n*c*c and r = s - c*n, wrapping like int64
    const unsigned long long d2 = sq - 2ull * uc * s + un * uc * uc;
    const unsigned long long r = s - uc * un;
    const long long var =
        floor_div((long long)(un * d2 - r * r), (long long)(un * un));
    const unsigned mean16 = (unsigned)(c & 0xFFFF);
    const unsigned median16 = (unsigned)(((ml + mh) / 2) & 0xFFFF);
    const unsigned var16 = (unsigned)(var & 0xFFFF);
    const unsigned avg = (unsigned)(mid_k2 & 0xFFFF);
    const unsigned long long kmer =
        ((unsigned long long)first_key ^ (1ull << 63)) >> 16;
    Picked p;
    p.word = make_uint4(
        (unsigned)(kmer >> 16),
        (unsigned)(((kmer & 0xFFFFu) << 16) | (unsigned)best_func),
        (mean16 << 16) | median16, (var16 << 16) | avg);
    p.kept = !((float)n < (float)ktotal * threshold);
    return p;
}

// one thread, a group of at most SMALL entries gs..ge-1 of the stage
__device__ Picked thread_group(const Stage &st, int gs, int ge,
                               float threshold) {
    int run_func = (int)(st.k1[gs] & 0xFFFF);
    int run_start = gs, best_count = 0, best_start = gs;
    int best_func = run_func;
    for (int i = gs + 1; i < ge; i++) {
        const int f = (int)(st.k1[i] & 0xFFFF);
        if (f != run_func) {
            if (i - run_start > best_count) {
                best_count = i - run_start;
                best_func = run_func;
                best_start = run_start;
            }
            run_start = i;
            run_func = f;
        }
    }
    if (ge - run_start > best_count) {
        best_count = ge - run_start;
        best_func = run_func;
        best_start = run_start;
    }
    unsigned long long s = 0, sq = 0;
    for (int i = best_start; i < best_start + best_count; i++) {
        const unsigned long long x = (unsigned)st.pl[i];
        s += x;
        sq += x * x;
    }
    const int ktotal = ge - gs;
    return finish(ktotal, best_count, best_func, s, sq,
                  st.pl[best_start + (best_count - 1) / 2],
                  st.pl[best_start + best_count / 2], st.k1[gs],
                  st.k2[gs + ktotal / 2], threshold);
}

// one warp, the group that starts at gs of k1/pl/k2 and ends at the first
// entry of another k-mer or at limit: shared or global memory alike
__device__ Picked warp_group(const long long *k1, const int32_t *pl,
                             const long long *k2, long long gs,
                             long long limit, float threshold) {
    const int lane = threadIdx.x & 31;
    const long long km = kmer_of(k1[gs]);
    int run_func = (int)(k1[gs] & 0xFFFF);
    long long run_start = gs, best_count = 0, best_start = gs;
    int best_func = run_func, before = run_func;
    long long ge = limit;
    for (long long base = gs;; base += 32) {
        const long long i = base + lane;
        const long long key = i < limit ? k1[i] : 0;
        const bool in = i < limit && kmer_of(key) == km;
        const int f = in ? (int)(key & 0xFFFF) : -1;
        int prev = __shfl_up_sync(FULL, f, 1);
        if (lane == 0) prev = before;
        const unsigned inside = __ballot_sync(FULL, in);
        unsigned m = __ballot_sync(FULL, in && f != prev);
        while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            const long long count = base + b - run_start;
            if (count > best_count) {
                best_count = count;
                best_func = run_func;
                best_start = run_start;
            }
            run_start = base + b;
            run_func = __shfl_sync(FULL, f, b);
        }
        if (inside != FULL) {  // the group ends in this step
            ge = base + __popc(inside);
            break;
        }
        before = __shfl_sync(FULL, f, 31);
    }
    if (ge - run_start > best_count) {
        best_count = ge - run_start;
        best_func = run_func;
        best_start = run_start;
    }
    unsigned long long s = 0, q = 0;
    for (long long i = best_start + lane; i < best_start + best_count;
         i += 32) {
        const unsigned long long x = (unsigned)pl[i];
        s += x;
        q += x * x;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    const long long ktotal = ge - gs;
    Picked p = finish(ktotal, best_count, best_func, s, q,
                      pl[best_start + (best_count - 1) / 2],
                      pl[best_start + best_count / 2], k1[gs],
                      k2[gs + ktotal / 2], threshold);
    p.end = ge;
    return p;
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(gmem) : "memory");
}

// n elements from src to dst: 16-byte copies, then the ragged tail
template <typename T>
__device__ __forceinline__ void stage_copy(T *dst, const T *src, int n) {
    constexpr int PER = 16 / sizeof(T);
    const int nvec = n / PER;
    for (int v = threadIdx.x; v < nvec; v += THREADS)
        cp_async16(dst + v * PER, src + v * PER);
    for (int i = nvec * PER + threadIdx.x; i < n; i += THREADS)
        dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) select_kernel(
        const long long *__restrict__ k1s, const int32_t *__restrict__ plen,
        const long long *__restrict__ k2s, const int32_t *__restrict__ seq,
        long long N, long long n_tiles, int n_seqs, float threshold,
        uint4 *__restrict__ words, uint8_t *__restrict__ flags,
        unsigned long long *__restrict__ scratch) {
    unsigned long long *bad = scratch + 2 + n_tiles;
    __shared__ Stage st;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long tile = skt::take_tile(scratch, &st.tile);
    const long long t0 = tile * TILE;
    const int P = (int)(N - t0 < STAGE ? N - t0 : STAGE);

    stage_copy(st.k1, k1s + t0, P);
    stage_copy(st.k2, k2s + t0, P);
    stage_copy(st.pl, plen + t0, P);
    stage_copy(st.sq, seq + t0, P);
    asm volatile("cp.async.wait_all;" ::: "memory");
    if (tid == 0) st.n_large = 0;
    __syncthreads();

    // group starts: a bit per staged entry, then their list in order
    for (int c = warp; c < CHUNKS; c += WARPS) {
        const int p = c * 32 + lane;
        bool start = false;
        if (p < P) {
            const long long prev = p > 0 ? st.k1[p - 1]
                                 : t0 > 0 ? k1s[t0 - 1] : 0;
            start = (p == 0 && t0 == 0) || kmer_of(st.k1[p]) != kmer_of(prev);
        }
        const unsigned m = __ballot_sync(FULL, start);
        if (lane == 0) st.mask[c] = m;
    }
    __syncthreads();
    if (warp == 0) {  // TILE is 32 chunks: one per lane, then the halo
        const int n = __popc(st.mask[lane]);
        int incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += y;
        }
        st.chunk_base[lane] = incl - n;
        if (lane == 31) {
            st.n_tile = incl;
            st.chunk_base[CHUNKS - 1] = incl;
            const int n_all = incl + __popc(st.mask[CHUNKS - 1]);
            st.list[n_all] = t0 + P == N ? (unsigned short)P : UNKNOWN;
        }
    }
    static_assert(CHUNKS == 33, "a lane per tile chunk, then one halo chunk");
    __syncthreads();
    for (int c = warp; c < CHUNKS; c += WARPS) {
        const unsigned m = st.mask[c];
        if ((m >> lane) & 1u)
            st.list[st.chunk_base[c] + __popc(m & ((1u << lane) - 1u))] =
                (unsigned short)(c * 32 + lane);
    }
    __syncthreads();

    // a thread per small group; the large ones to the list
    const int n_tile = st.n_tile;
    Picked mine[PER_THREAD];
    int large_at[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        const int j = tid + k * THREADS;
        large_at[k] = -1;
        mine[k].kept = false;
        if (j >= n_tile) continue;
        const int gs = st.list[j], ge = st.list[j + 1];
        if (ge != UNKNOWN && ge - gs <= SMALL) {
            mine[k] = thread_group(st, gs, ge, threshold);
        } else {
            large_at[k] = atomicAdd(&st.n_large, 1);
            st.large_j[large_at[k]] = j;
        }
    }
    __syncthreads();
    for (int q = warp; q < st.n_large; q += WARPS) {
        const int j = st.large_j[q];
        const int gs = st.list[j], ge = st.list[j + 1];
        const Picked p =
            ge != UNKNOWN
                ? warp_group(st.k1, st.pl, st.k2, gs, ge, threshold)
                : warp_group(k1s, plen, k2s, t0 + gs, N, threshold);
        if (lane == 0) {
            st.large_word[q] = p.word;
            st.large_kept[q] = p.kept;
            st.large_end[q] = ge != UNKNOWN ? p.end : p.end - t0;
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        const int j = tid + k * THREADS;
        if (large_at[k] >= 0) {
            mine[k].word = st.large_word[large_at[k]];
            mine[k].kept = st.large_kept[large_at[k]];
        }
        if (j < n_tile) st.kept[j] = mine[k].kept;
    }
    __syncthreads();

    // the kept groups' offsets in group order: PER_THREAD flags a thread
    int c[PER_THREAD], own = 0;
#pragma unroll
    for (int i = 0; i < PER_THREAD; i++) {
        const int j = tid * PER_THREAD + i;
        c[i] = j < n_tile ? st.kept[j] : 0;
        own += c[i];
    }
    int incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
    }
    if (lane == 31) st.warp_total[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < WARPS; w++) {
        before += w < warp ? st.warp_total[w] : 0;
        total += st.warp_total[w];
    }
    int off = before + incl - own;
#pragma unroll
    for (int i = 0; i < PER_THREAD; i++) {
        const int j = tid * PER_THREAD + i;
        if (j < n_tile) st.koff[j] = (unsigned short)off;
        off += c[i];
    }
    if (warp == 0) {
        const unsigned long long b = skt::exclusive_prefix(
            scratch, tile, n_tiles, (unsigned long long)total);
        if (lane == 0) st.base = b;
    }
    // the kept groups' sequence flags, while warp 0 looks back (and then
    // by it too): a thread each for the small groups, a warp for a large.
    // A flag is loaded and stored only where the load reads 0 (a stale 0
    // costs only a store that another thread also makes); the loads go
    // first, since a store may alias a later load and would hold it back.
    // The small groups' first entries (all of a singleton), then the rest:
    int first[PER_THREAD];
    bool seen[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        const bool mine_small = mine[k].kept && large_at[k] < 0;
        first[k] = mine_small ? st.sq[st.list[tid + k * THREADS]] : 0;
        seen[k] = !mine_small || !seq_ok(first[k], n_seqs, bad) ||
                  flags[first[k]];
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++)
        if (!seen[k]) flags[first[k]] = 1;
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        const int j = tid + k * THREADS;
        if (mine[k].kept && large_at[k] < 0)
            for (int i = st.list[j] + 1; i < st.list[j + 1]; i++)
                if (seq_ok(st.sq[i], n_seqs, bad) && !flags[st.sq[i]])
                    flags[st.sq[i]] = 1;
    }
    for (int q = warp; q < st.n_large; q += WARPS) {
        if (!st.large_kept[q]) continue;
        const int j = st.large_j[q];
        const int32_t *sq = st.list[j + 1] != UNKNOWN ? st.sq : seq + t0;
        const long long end = st.large_end[q];
        for (long long i = st.list[j] + lane; i < end; i += 4 * 32) {
            int s4[4];
            bool seen4[4];
#pragma unroll
            for (int u = 0; u < 4; u++) {
                s4[u] = i + 32 * u < end ? sq[i + 32 * u] : 0;
                seen4[u] = i + 32 * u >= end ||
                           !seq_ok(s4[u], n_seqs, bad) || flags[s4[u]];
            }
#pragma unroll
            for (int u = 0; u < 4; u++)
                if (!seen4[u]) flags[s4[u]] = 1;
        }
    }
    __syncthreads();
    const unsigned long long base = st.base;
#pragma unroll
    for (int k = 0; k < PER_THREAD; k++) {
        const int j = tid + k * THREADS;
        if (j < n_tile && mine[k].kept) words[base + st.koff[j]] = mine[k].word;
    }
}

}  // namespace

// scratch: scratch_words zeroed 64-bit words, at least 3 + the tiles: the
// look-back's 2 + n_tiles (lookback.cuh), then a word set to 1 when a kept
// entry's sequence index lies outside [0, n_seqs).  Returns -1, launching
// nothing, when scratch is shorter.
extern "C" int skt_build_select_runs(
        const void *k1s, const void *plen_s, const void *k2s,
        const void *seq_s, long N, int n_seqs, float threshold, void *words,
        void *flags, void *scratch, long scratch_words, void *stream) {
    if (N > 0) {
        const long long n_tiles = (N + TILE - 1) / TILE;
        if (scratch_words < 3 + n_tiles) return -1;
        select_kernel<<<(unsigned)n_tiles, THREADS, 0,
                        (cudaStream_t)stream>>>(
            (const long long *)k1s, (const int32_t *)plen_s,
            (const long long *)k2s, (const int32_t *)seq_s, N, n_tiles,
            n_seqs, threshold, (uint4 *)words, (uint8_t *)flags,
            (unsigned long long *)scratch);
    }
    return (int)cudaGetLastError();
}
