// Build-side window extraction: the valid 8-mer windows of a corpus in
// the 8-bit transfer rows, compacted and packed as sort keys.  One warp
// per sequence, one pass over the codes.
//
// Replaces the XLA programs of the JAX package's build
// (models/signature_builder.py: _extract_windows_jax, lines 429-479, a
// scatter of per-sequence metadata and a 4-lane segmented max-scan as a
// forward fill, and ops/kmer_pack.py: pack_flat_windows, line 335, the
// window shifts and the windowed cumsum of the all-amino-acid test).
// Here a warp owns one sequence, so it holds the sequence's metadata
// without any scan, and the output holds the valid windows only (in
// sequence order, then position), where the JAX layout keeps every slot
// and marks the invalid ones with SENTINEL keys.
//
// A window at position p of sequence b (start = aligned start, n = length)
// is valid when p + 8 <= n and its 8 codes are all among the 20 amino
// acids of either case (bit c of aa_mask).  Per valid window:
//   key_f = ((kmer48 << 16) | (fidx & 0xFFFF)) ^ (1 << 63)
//   key_o = ((kmer48 << 16) | ((n - p) & 0xFFFF)) ^ (1 << 63)
//   plen  = n,  seq = b
// with kmer48 the eight 6-bit codes, first code highest.  The sign flip
// makes torch's signed int64 sort order the unsigned order of the key: a
// k-mer whose first code is a lowercase residue (codes 26-51) has bit 63
// set and would sort first without it.  seq is the dense sequence index
// that the selection carries through its sort (ops/build_select.py).
//
// Design.  A block takes the next tile of WARPS sequences (tile ids in
// start order, lookback.cuh); each warp copies its sequence's 16-aligned
// row span into shared memory with 16-byte loads and counts its valid
// windows there.  The block sums the counts, takes its output offset by
// decoupled look-back, and each warp writes its windows from shared memory
// at the offset plus their rank (a ballot prefix).  So the codes are read
// once, no host round trip sits between a count and the writes, and the
// order is fixed.  A span longer than CHUNK bytes goes through in chunks
// (overlapping by 16 codes, so every window of a chunk is whole); such a
// sequence is read twice, once to count and once to write.  The outputs
// are sized by the caller (cap windows, the wrapper's is the code count,
// at least sum(max(n - 7, 0)) for disjoint spans); writes past cap are
// dropped and the wrapper raises.
//
// Bound on the H100: bytes.  The function reads each code once (1 byte per
// residue slot of the rows) and 12 bytes of metadata per sequence, and
// writes 24 bytes per valid window: ~2.2 GB for the 300K-sequence corpus
// (88M windows), ~0.66 ms at 3.35 TB/s.  The windows' four outputs are
// stored as 32 consecutive 8- and 4-byte words per step (minus the invalid
// lanes).

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int WARPS = 8;            // sequences per block (a tile)
constexpr int CHUNK = 2048;         // codes a warp holds at once
constexpr int STEP = CHUNK - 16;    // a chunk's whole windows
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Stage {
    alignas(16) uint8_t codes[WARPS][CHUNK];
    int count[WARPS];
    int before[WARPS];  // the windows of the block's earlier warps
    long long tile;
    unsigned long long base;
};

struct Window {
    bool valid;
    unsigned long long kmer;
};

// the window at buf[q..q+7], valid when inside (p + 8 <= n)
__device__ __forceinline__ Window window_at(const uint8_t *buf, int q,
                                            bool inside,
                                            unsigned long long aa_mask) {
    Window w{inside, 0ull};
    if (inside) {
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const unsigned c = buf[q + j];
            w.valid = w.valid && ((aa_mask >> c) & 1ull);
            w.kmer = (w.kmer << 6) | c;
        }
    }
    return w;
}

// codes[from, from + len) -> buf, len a multiple of 16
__device__ __forceinline__ void load_chunk(uint8_t *buf, const uint8_t *src,
                                           int len, int lane) {
    const uint4 *s = reinterpret_cast<const uint4 *>(src);
    uint4 *d = reinterpret_cast<uint4 *>(buf);
    for (int v = lane; v < len / 16; v += 32) d[v] = __ldg(s + v);
    __syncwarp();
}

// the end of the windows [cs, end) that the chunk at cs holds whole: all
// the rest when the chunk reaches the span's end, else STEP of them (the
// next chunk starts there, 16-aligned)
__device__ __forceinline__ int chunk_end(int cs, int span, int nwin) {
    const int end = cs + CHUNK >= span ? nwin : cs + STEP;
    return end < nwin ? end : nwin;
}

__global__ void __launch_bounds__(WARPS * 32) extract_kernel(
        const uint8_t *__restrict__ codes, const int32_t *__restrict__ starts,
        const int32_t *__restrict__ fidx, const int32_t *__restrict__ plen,
        int B, unsigned long long aa_mask, long long cap,
        long long *__restrict__ key_f, long long *__restrict__ key_o,
        int32_t *__restrict__ plen_w, int32_t *__restrict__ seq_w,
        unsigned long long *__restrict__ scratch) {
    __shared__ Stage st;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long tile = skt::take_tile(scratch, &st.tile);
    const long long n_tiles = (B + WARPS - 1) / WARPS;
    const long long b = tile * WARPS + warp;
    const int n = b < B ? plen[b] : 0;
    const int nwin = n > 7 ? n - 7 : 0;
    const int span = (n + 15) & ~15;
    const uint8_t *src = codes + (b < B ? (long long)starts[b] : 0);
    uint8_t *buf = st.codes[warp];

    int count = 0;
    for (int cs = 0, end; cs < nwin; cs = end) {
        load_chunk(buf, src + cs, span - cs < CHUNK ? span - cs : CHUNK,
                   lane);
        end = chunk_end(cs, span, nwin);
        for (int p0 = cs; p0 < end; p0 += 32) {
            const int p = p0 + lane;
            const Window w = window_at(buf, p - cs, p < end, aa_mask);
            count += __popc(__ballot_sync(FULL, w.valid));
        }
        __syncwarp();
    }
    if (lane == 0) st.count[warp] = count;
    __syncthreads();
    if (warp == 0) {
        const int c = lane < WARPS ? st.count[lane] : 0;
        int incl = c;
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += y;
        }
        if (lane < WARPS) st.before[lane] = incl - c;
        const int total = __shfl_sync(FULL, incl, WARPS - 1);
        const unsigned long long base = skt::exclusive_prefix(
            scratch, tile, n_tiles, (unsigned long long)total);
        if (lane == 0) st.base = base;
    }
    __syncthreads();

    const unsigned long long f16 =
        b < B ? (unsigned)fidx[b] & 0xFFFFu : 0u;
    const unsigned long long sign = 1ull << 63;
    long long out = (long long)(st.base + st.before[warp]);
    // a span that fits one chunk is still in shared memory
    const bool resident = span <= CHUNK;
    for (int cs = 0, end; cs < nwin; cs = end) {
        if (!resident)
            load_chunk(buf, src + cs,
                       span - cs < CHUNK ? span - cs : CHUNK, lane);
        end = chunk_end(cs, span, nwin);
        for (int p0 = cs; p0 < end; p0 += 32) {
            const int p = p0 + lane;
            const Window w = window_at(buf, p - cs, p < end, aa_mask);
            const unsigned m = __ballot_sync(FULL, w.valid);
            const long long i = out + __popc(m & ((1u << lane) - 1u));
            if (w.valid && i < cap) {
                const unsigned long long off = (unsigned)(n - p) & 0xFFFFu;
                key_f[i] = (long long)(((w.kmer << 16) | f16) ^ sign);
                key_o[i] = (long long)(((w.kmer << 16) | off) ^ sign);
                plen_w[i] = n;
                seq_w[i] = (int32_t)b;
            }
            out += __popc(m);
        }
        __syncwarp();
    }
}

}  // namespace

// scratch: scratch_words zeroed 64-bit words, at least the look-back's
// 2 + the tiles (lookback.cuh).  Returns -1, launching nothing, when it is
// shorter.
extern "C" int skt_build_extract_windows(
        const void *codes, const void *starts, const void *fidx,
        const void *plen, int B, unsigned long long aa_mask, long cap,
        void *key_f, void *key_o, void *plen_w, void *seq_w, void *scratch,
        long scratch_words, void *stream) {
    if (B > 0) {
        if (scratch_words < 2 + (B + WARPS - 1) / WARPS) return -1;
        extract_kernel<<<(unsigned)((B + WARPS - 1) / WARPS), WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
            (const uint8_t *)codes, (const int32_t *)starts,
            (const int32_t *)fidx, (const int32_t *)plen, B, aa_mask, cap,
            (long long *)key_f, (long long *)key_o, (int32_t *)plen_w,
            (int32_t *)seq_w, (unsigned long long *)scratch);
    }
    return (int)cudaGetLastError();
}
