// BDZ search of a reference CMPH store, with the reference's aliasing,
// with or without the value words.
//
// Replaces the XLA program the JAX package builds from
// table/cmph_table.py: CmphKmerTable.probe (lines 131-199), with
// interop/hashes.py: jenkins_mix (:25).  One entry point,
// skt_probe_cmph: with vrec NULL it is the call path's probe (found, fm)
// reading vfm; with vrec it also returns the indexed record's three value
// words, reading vrec instead.
//
// Per window (the reference's cmph_search + flat array read,
// cmph_kmer.h:138-147, bdz.c):
// - the key's 8 bytes as the reference stores them: each 6-bit code
//   through CODE_TO_BYTE (core/alphabet.py; codes 26-51 are lower-case
//   letters, 52 is '*'), k[0..3] little-endian from hi, k[4..7] from lo;
// - cmph's Jenkins lookup2 for an 8-byte key: a = word(k0..3) + GOLDEN,
//   b = word(k4..7) + GOLDEN, c = seed + 8, one mix, in uint32
//   wraparound -> (h0, h1, h2);
// - the three vertices h0 % r, h1 % r + r, h2 % r + 2r (r is odd, not a
//   power of two), their 2-bit g values, and sel = (g0 + g1 + g2) % 3
//   picks one;
// - the reference then reads idx = rank(vertex) and the record at idx,
//   a miss only where idx == m.  The rank is a cumsum over assigned
//   vertices and never decreases, so idx < m exactly for the vertices
//   below one boundary n_live, and the store's device layout
//   (CmphKmerTable.to_device) has resolved rank -> record per vertex
//   when it opened: vfm[vertex] = the record's fm = (v0 & 0xFFFF0000) |
//   (v1 & 0xFFFF), vrec[vertex] = (v0, v1, v2, 0).  So:
//   found = vertex < n_live & valid, fm = vfm[vertex] (aux: from
//   vrec[vertex]), every word 0 where not found; without aux found also
//   drops fm>>16 == ignore_function.
// A key outside the set reads some real record: that is the store's
// specified result, not a fault.
//
// Bound on the H100: random reads.  g is 3r/4 bytes (5.9 MiB at 20M
// keys), which the 50 MB L2 holds, so the three g bytes of a window are
// L2 hits; the one DRAM read is the vertex's word (4 bytes of a 98 MB
// array) or record (16 bytes of 393 MB): one 32-byte sector per valid
// window, where the rank route read three (the rank, then v0 and v1,
// which waited on it).  The streaming part is 9 bytes in and 5 out per
// window (12 more out with aux).  The hash is ~40 integer operations and
// three 32-bit remainders.  Design: one thread per window, whose three
// g bytes are requested together, then its one vertex read; nothing read
// from DRAM waits on another DRAM read, and an invalid window reads
// nothing.  The streams are read and written evict-first (__ldcs,
// __stcs), so that g stays in L2 beside them; the g bytes and the vertex
// read take the read-only path (__ldg).  On the H100 four windows a
// thread (every g byte of the four, then every vertex read, in flight
// together), evict-first vertex reads and an L2 evict-last policy on
// the g bytes each measured no faster (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr uint32_t GOLDEN = 0x9E3779B9u;

// core/alphabet.py: CODE_TO_BYTE ('A'..'Z', 'a'..'z', '*', then '?')
__constant__ uint8_t CODE_TO_BYTE[64] = {
    'A', 'B', 'C', 'D', 'E', 'F', 'G', 'H', 'I', 'J', 'K', 'L', 'M',
    'N', 'O', 'P', 'Q', 'R', 'S', 'T', 'U', 'V', 'W', 'X', 'Y', 'Z',
    'a', 'b', 'c', 'd', 'e', 'f', 'g', 'h', 'i', 'j', 'k', 'l', 'm',
    'n', 'o', 'p', 'q', 'r', 's', 't', 'u', 'v', 'w', 'x', 'y', 'z',
    '*', '?', '?', '?', '?', '?', '?', '?', '?', '?', '?', '?'};

// four 6-bit codes (c0 at bits 18-23 .. c3 at bits 0-5) -> their bytes
// as a little-endian word: k[0] | k[1] << 8 | k[2] << 16 | k[3] << 24
__device__ __forceinline__ uint32_t word_le(uint32_t w) {
    return (uint32_t)CODE_TO_BYTE[(w >> 18) & 63u] |
           ((uint32_t)CODE_TO_BYTE[(w >> 12) & 63u] << 8) |
           ((uint32_t)CODE_TO_BYTE[(w >> 6) & 63u] << 16) |
           ((uint32_t)CODE_TO_BYTE[w & 63u] << 24);
}

// the key's three BDZ vertices
__device__ __forceinline__ void vertices(uint32_t hi, uint32_t lo,
                                         uint32_t seed, uint32_t r,
                                         uint32_t *x) {
    uint32_t a = word_le(hi) + GOLDEN;
    uint32_t b = word_le(lo) + GOLDEN;
    uint32_t c = seed + 8u;
    // Bob Jenkins' mix (cmph jenkins.c), uint32 wraparound
    a -= b; a -= c; a ^= c >> 13;
    b -= c; b -= a; b ^= a << 8;
    c -= a; c -= b; c ^= b >> 13;
    a -= b; a -= c; a ^= c >> 12;
    b -= c; b -= a; b ^= a << 16;
    c -= a; c -= b; c ^= b >> 5;
    a -= b; a -= c; a ^= c >> 3;
    b -= c; b -= a; b ^= a << 10;
    c -= a; c -= b; c ^= b >> 15;
    x[0] = a % r;
    x[1] = b % r + r;
    x[2] = c % r + 2u * r;
}

template <bool AUX>
__global__ void __launch_bounds__(THREADS) probe_cmph_kernel(
        const uint32_t *__restrict__ hi, const uint32_t *__restrict__ lo,
        const uint8_t *__restrict__ valid, long n,
        const uint8_t *__restrict__ g, const uint32_t *__restrict__ vfm,
        const uint4 *__restrict__ vrec, uint32_t seed, uint32_t r,
        uint32_t n_live, int ignore_function, uint8_t *__restrict__ found,
        uint32_t *__restrict__ fm, uint32_t *__restrict__ r0,
        uint32_t *__restrict__ r1, uint32_t *__restrict__ r2) {
    const long i = (long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const bool v = __ldcs(valid + i);
    uint32_t x[3], gb[3];
    vertices(__ldcs(hi + i), __ldcs(lo + i), seed, r, x);
    // the three g bytes in flight together
#pragma unroll
    for (int k = 0; k < 3; k++) gb[k] = v ? __ldg(g + (x[k] >> 2)) : 0u;
    uint32_t s = 0u;
#pragma unroll
    for (int k = 0; k < 3; k++) s += (gb[k] >> ((x[k] & 3u) << 1)) & 3u;
    s %= 3u;
    const uint32_t vert = s == 0u ? x[0] : s == 1u ? x[1] : x[2];
    const bool live = v && vert < n_live;
    // the one read by the vertex
    uint32_t f;
    if constexpr (AUX) {
        const uint4 rec = live ? __ldg(vrec + vert)
                               : make_uint4(0u, 0u, 0u, 0u);
        f = (rec.x & 0xFFFF0000u) | (rec.y & 0xFFFFu);
        __stcs(r0 + i, rec.x);
        __stcs(r1 + i, rec.y);
        __stcs(r2 + i, rec.z);
    } else {
        f = live ? __ldg(vfm + vert) : 0u;
    }
    __stcs(found + i, (uint8_t)(live && (int)(f >> 16) != ignore_function));
    __stcs(fm + i, f);
}

}  // namespace

// n windows (hi, lo int32 words, valid bytes) against a BDZ store's
// device layout: g (ceil(3r/4) bytes), vfm (3r int32) and n_live; with
// vrec (3r records of 4 int32) NULL, the probe without value words
// (r0..r2 may then be NULL), else the aux probe, which reads vrec and not
// vfm; vrec 16-byte aligned.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for r or n_live out of range.
extern "C" int skt_probe_cmph(const void *hi, const void *lo,
                              const void *valid, long n, const void *g,
                              const void *vfm, const void *vrec,
                              unsigned seed, unsigned r, unsigned n_live,
                              int ignore_function, void *found, void *fm,
                              void *r0, void *r1, void *r2, void *stream) {
    if (r == 0 || (unsigned long)r * 3ul >= (1ul << 31) ||
        n_live > 3u * r)
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        auto kernel = vrec ? probe_cmph_kernel<true>
                           : probe_cmph_kernel<false>;
        kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(
            (const uint32_t *)hi, (const uint32_t *)lo,
            (const uint8_t *)valid, n, (const uint8_t *)g,
            (const uint32_t *)vfm, (const uint4 *)vrec, seed, r, n_live,
            ignore_function, (uint8_t *)found, (uint32_t *)fm,
            (uint32_t *)r0, (uint32_t *)r1, (uint32_t *)r2);
    }
    return (int)cudaGetLastError();
}
