// Wide tagged-bucket probe, four windows per thread.
//
// Replaces the XLA program the JAX package builds from ops/probe.py:
// probe_wide + _tagged_match (lines 141-192), with ops/hashing.py: perm48
// and wide_bucket_tag, for the no-aux case the caller runs.
//
// Per window: a 3-round Feistel permutation of the 48-bit key (hi, lo) is
// split into (bucket, tag); the main row packed[bucket] =
// [tag x slots | fm x slots] is matched against the tag.  When the build
// has overflow keys the lookup is repeated in the overflow leaf with the
// leaf's salt and bits.
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
// 50 MB L2.  The streaming part (hi, lo, valid in; found, fm out) is
// 14 bytes per window.  The hash is a few dozen integer operations, far
// below the memory time.  Design, so that each thread keeps many
// independent reads in flight and issues few load instructions:
// - a thread takes 4 consecutive windows: hi and lo arrive as one 16-byte
//   load each, valid as one 4-byte load, and found and fm leave as one
//   4-byte and one 16-byte store (the wrapper requires 16-byte aligned
//   tensors); the last thread takes the n % 4 tail one window at a time;
// - all four buckets are computed first, then all four main rows are
//   read as 16-byte read-only loads (one per row at 2 slots, two at 4)
//   before any tag is compared;
// - only the windows whose main row missed read the leaf, after the
//   compare.  Reading the leaf of every valid window beside its main row
//   (one latency instead of two) measured slower on the H100: the leaf
//   lookups are bound by load throughput, not latency, and that doubles
//   them (PERF.md);
// - the leaf's slot count S is the build's observed maximum; its tags are
//   read four at a time (16-byte loads) where S is even, so that rows
//   start on 16 bytes, else two at a time;
// - what is read or written once (hi, lo, valid, the main rows, found and
//   fm) is loaded and stored evict-first (__ldcs, __stcs), so that the
//   ~100 MB that pass through L2 in a call do not push the leaf out of it.
// Results do not depend on the order: fm = main match ? main fm : leaf fm.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t M24 = 0xFFFFFFu;
constexpr int VEC = 4;        // windows per thread
constexpr int THREADS = 128;  // threads per block

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// perm48 and wide_bucket_tag: the key's bucket and tag under (salt, bits)
__device__ __forceinline__ void bucket_tag(uint32_t hi, uint32_t lo,
                                           uint32_t salt, int bits,
                                           uint32_t &bucket, uint32_t &tag) {
    const uint32_t rc[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};
    uint32_t L = hi & M24, R = lo & M24;
#pragma unroll
    for (int r = 0; r < 3; r++) {
        uint32_t F = fmix32(R ^ (salt ^ rc[r])) & M24;
        uint32_t t = L ^ F;
        L = R;
        R = t;
    }
    if (bits <= 24) {
        bucket = R & ((1u << bits) - 1u);
        tag = (L << (24 - bits)) | (R >> bits);
    } else {
        bucket = ((L & ((1u << (bits - 24)) - 1u)) << 24) | R;
        tag = L >> (bits - 24);
    }
}

// K consecutive 32-bit words, one K*4-byte read-only load (K = 2 or 4)
template <int K>
struct Words;
template <>
struct Words<2> {
    uint2 v;
    __device__ void load(const uint32_t *p) { v = __ldg((const uint2 *)p); }
    __device__ uint32_t operator[](int k) const { return k ? v.y : v.x; }
};
template <>
struct Words<4> {
    uint4 v;
    __device__ void load(const uint32_t *p) { v = __ldg((const uint4 *)p); }
    __device__ uint32_t operator[](int k) const {
        return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    }
};

// Leaf lookups of the windows with want[i]: f[i] |= a tag matched, fm[i] +=
// the matching slots' fm words (tags are unique within a bucket).  Rows are
// 2*S words and start on 8*S bytes; the tags are read K at a time, so the
// last read may run into the row's fm words but never past the row.
template <int K>
__device__ __forceinline__ void leaf_lookup(
        const uint32_t *__restrict__ ov, int S, const uint32_t *bucket,
        const uint32_t *tag, const bool *want, bool *f, uint32_t *fm) {
    const uint32_t *row[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++) row[i] = ov + (size_t)bucket[i] * 2 * S;
    for (int s = 0; s < S; s += K) {
        Words<K> t[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++)
            if (want[i]) t[i].load(row[i] + s);
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            if (!want[i]) continue;
#pragma unroll
            for (int k = 0; k < K; k++) {
                if (s + k < S && t[i][k] == tag[i]) {
                    f[i] = true;
                    fm[i] += __ldg(row[i] + S + s + k);
                }
            }
        }
    }
}

__device__ __forceinline__ void leaf_lookups(
        const uint32_t *__restrict__ ov, int S, uint32_t salt, int bits,
        const uint32_t *h, const uint32_t *l, const bool *want, bool *f,
        uint32_t *fm) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < VEC; i++) any |= want[i];
    if (!any) return;
    uint32_t bucket[VEC], tag[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++)
        bucket_tag(h[i], l[i], salt, bits, bucket[i], tag[i]);
    if (S % 2 == 0)  // rows start on 16 bytes
        leaf_lookup<4>(ov, S, bucket, tag, want, f, fm);
    else
        leaf_lookup<2>(ov, S, bucket, tag, want, f, fm);
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS) probe_wide_kernel(
        const uint32_t *__restrict__ hi, const uint32_t *__restrict__ lo,
        const uint8_t *__restrict__ valid, long n,
        const uint4 *__restrict__ packed, uint32_t salt, int bits,
        const uint32_t *__restrict__ ov_packed, int ov_slots,
        uint32_t ov_salt, int ov_bits, bool has_overflow,
        int ignore_function, uint8_t *__restrict__ found,
        uint32_t *__restrict__ fm_out) {
    constexpr int Q = SLOTS / 2;  // 16-byte words per main row
    const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    const long base = t * VEC;
    if (base >= n) return;
    const bool whole = base + VEC <= n;

    uint32_t h[VEC], l[VEC];
    bool v[VEC];
    if (whole) {
        uint4 a = __ldcs((const uint4 *)hi + t);
        uint4 b = __ldcs((const uint4 *)lo + t);
        uchar4 q = __ldcs((const uchar4 *)valid + t);
        h[0] = a.x, h[1] = a.y, h[2] = a.z, h[3] = a.w;
        l[0] = b.x, l[1] = b.y, l[2] = b.z, l[3] = b.w;
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            bool in = base + i < n;
            h[i] = in ? hi[base + i] : 0u;
            l[i] = in ? lo[base + i] : 0u;
            v[i] = in && valid[base + i];
        }
    }

    uint32_t bkt[VEC], tag[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++)
        bucket_tag(h[i], l[i], salt, bits, bkt[i], tag[i]);
    uint4 row[VEC][Q];  // every main row in flight before any compare
#pragma unroll
    for (int i = 0; i < VEC; i++)
#pragma unroll
        for (int q = 0; q < Q; q++)
            row[i][q] = v[i] ? __ldcs(packed + (size_t)bkt[i] * Q + q)
                             : make_uint4(0u, 0u, 0u, 0u);

    bool f[VEC];
    uint32_t fm1[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++) {
        uint32_t w[2 * SLOTS];  // tags, then fm words
#pragma unroll
        for (int q = 0; q < Q; q++) {
            w[4 * q] = row[i][q].x;
            w[4 * q + 1] = row[i][q].y;
            w[4 * q + 2] = row[i][q].z;
            w[4 * q + 3] = row[i][q].w;
        }
        f[i] = false;
        fm1[i] = 0u;
#pragma unroll
        for (int s = 0; s < SLOTS; s++) {
            if (w[s] == tag[i]) {
                f[i] = true;
                fm1[i] += w[SLOTS + s];
            }
        }
    }

    bool f2[VEC] = {};
    uint32_t fm2[VEC] = {};
    if (has_overflow) {  // the misses only
        bool miss[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++) miss[i] = v[i] && !f[i];
        leaf_lookups(ov_packed, ov_slots, ov_salt, ov_bits, h, l, miss, f2,
                     fm2);
    }

    uint8_t fo[VEC];
    uint32_t mo[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++) {
        uint32_t fm = f[i] ? fm1[i] : fm2[i];
        fo[i] = v[i] && (f[i] || f2[i]) && (int)(fm >> 16) != ignore_function;
        mo[i] = v[i] ? fm : 0u;
    }
    if (whole) {
        __stcs((uchar4 *)found + t, make_uchar4(fo[0], fo[1], fo[2], fo[3]));
        __stcs((uint4 *)fm_out + t, make_uint4(mo[0], mo[1], mo[2], mo[3]));
    } else {
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            if (base + i < n) {
                found[base + i] = fo[i];
                fm_out[base + i] = mo[i];
            }
        }
    }
}

}  // namespace

// slots must be 2 or 4 and every pointer 16-byte aligned (the wrapper
// checks both)
extern "C" int skt_probe_wide(const void *hi, const void *lo,
                              const void *valid, long n, const void *packed,
                              int slots, unsigned salt, int bits,
                              const void *ov_packed, int ov_slots,
                              unsigned ov_salt, int ov_bits, int has_overflow,
                              int ignore_function, void *found, void *fm,
                              void *stream) {
    if (slots != 2 && slots != 4) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        long blocks = ((n + VEC - 1) / VEC + THREADS - 1) / THREADS;
        auto kernel = slots == 2 ? probe_wide_kernel<2>
                                 : probe_wide_kernel<4>;
        kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t *)hi, (const uint32_t *)lo,
            (const uint8_t *)valid, n, (const uint4 *)packed, salt, bits,
            (const uint32_t *)ov_packed, ov_slots, ov_salt, ov_bits,
            has_overflow != 0, ignore_function,
            (uint8_t *)found, (uint32_t *)fm);
    }
    return (int)cudaGetLastError();
}
