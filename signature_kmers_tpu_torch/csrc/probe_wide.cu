// Wide tagged-bucket probes.
//
// Replaces the XLA programs the JAX package builds from ops/probe.py:
// probe_wide + _tagged_match (lines 141-192), with ops/hashing.py: perm48
// and wide_bucket_tag.  Three entry points:
// - skt_probe_wide: the no-aux case the call path runs, on the (hi, lo,
//   valid) words that pack_call_windows_rows16 wrote;
// - skt_probe_wide_aux: probe_wide with aux and _gather_aux (:158-193),
//   the matched slot's three value words (gather_hits_batch), reading the
//   transfer rows itself (the pack fused in);
// - skt_probe_wide_distance: models/matrix_distance.py:
//   MatrixDistance._gather's jitted f (:192-234), pack, probe and the
//   hypothetical and length filters, the found mask alone out, reading
//   the transfer rows itself and one distance row per window.
// All three share the hash and the leaf lookups.  The call-path
// probe's design first.
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
// The two fused entry points are described before their kernels below.

#include <cstdint>
#include <cuda_runtime.h>

#include "windows16.cuh"

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
// the matching slots' fm words (tags are unique within a bucket), slot[i] =
// the matching slot.  Rows are 2*S words and start on 8*S bytes; the tags
// are read K at a time, so the last read may run into the row's fm words
// but never past the row.
template <int K>
__device__ __forceinline__ void leaf_lookup(
        const uint32_t *__restrict__ ov, int S, const uint32_t *bucket,
        const uint32_t *tag, const bool *want, bool *f, uint32_t *fm,
        int *slot) {
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
                    slot[i] = s + k;
                }
            }
        }
    }
}

// The leaf's (bucket, tag) of every window, then the lookups of those with
// want[i]; the buckets are left in bucket[] for the aux reads.
__device__ __forceinline__ void leaf_lookups(
        const uint32_t *__restrict__ ov, int S, uint32_t salt, int bits,
        const uint32_t *h, const uint32_t *l, const bool *want, bool *f,
        uint32_t *fm, uint32_t *bucket, int *slot) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < VEC; i++) any |= want[i];
    if (!any) return;
    uint32_t tag[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++)
        bucket_tag(h[i], l[i], salt, bits, bucket[i], tag[i]);
    if (S % 2 == 0)  // rows start on 16 bytes
        leaf_lookup<4>(ov, S, bucket, tag, want, f, fm, slot);
    else
        leaf_lookup<2>(ov, S, bucket, tag, want, f, fm, slot);
}

// The thread's windows base .. base+3: hi and lo as one 16-byte load
// each and valid as one 4-byte load when all four exist (whole), else one
// at a time, with v false past n.
__device__ __forceinline__ bool load_windows(
        const uint32_t *__restrict__ hi, const uint32_t *__restrict__ lo,
        const uint8_t *__restrict__ valid, long n, long t, uint32_t *h,
        uint32_t *l, bool *v) {
    const long base = t * VEC;
    const bool whole = base + VEC <= n;
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
    return whole;
}

// Main-row lookups of the valid windows: bkt[i] and tag from (salt, bits),
// every main row in flight before any compare (one 16-byte load per row
// at 2 slots, two at 4), then f[i], fm[i] and the matching slot[i].
template <int SLOTS>
__device__ __forceinline__ void main_lookups(
        const uint4 *__restrict__ packed, uint32_t salt, int bits,
        const uint32_t *h, const uint32_t *l, const bool *v, uint32_t *bkt,
        bool *f, uint32_t *fm, int *slot) {
    constexpr int Q = SLOTS / 2;  // 16-byte words per main row
    uint32_t tag[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++)
        bucket_tag(h[i], l[i], salt, bits, bkt[i], tag[i]);
    uint4 row[VEC][Q];
#pragma unroll
    for (int i = 0; i < VEC; i++)
#pragma unroll
        for (int q = 0; q < Q; q++)
            row[i][q] = v[i] ? __ldcs(packed + (size_t)bkt[i] * Q + q)
                             : make_uint4(0u, 0u, 0u, 0u);
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
        fm[i] = 0u;
        slot[i] = 0;
#pragma unroll
        for (int s = 0; s < SLOTS; s++) {
            if (w[s] == tag[i]) {
                f[i] = true;
                fm[i] += w[SLOTS + s];
                slot[i] = s;
            }
        }
    }
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
    const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
    const long base = t * VEC;
    if (base >= n) return;
    uint32_t h[VEC], l[VEC], bkt[VEC];
    bool v[VEC], f[VEC];
    uint32_t fm1[VEC];
    int slot[VEC];
    const bool whole = load_windows(hi, lo, valid, n, t, h, l, v);
    main_lookups<SLOTS>(packed, salt, bits, h, l, v, bkt, f, fm1, slot);

    bool f2[VEC] = {};
    uint32_t fm2[VEC] = {}, bkt2[VEC];
    int slot2[VEC];
    if (has_overflow) {  // the misses only
        bool miss[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++) miss[i] = v[i] && !f[i];
        leaf_lookups(ov_packed, ov_slots, ov_salt, ov_bits, h, l, miss, f2,
                     fm2, bkt2, slot2);
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


// ---- the fused probes: transfer rows in, no intermediate ------------------
//
// Both take what pack_call_windows_rows16 takes (the transfer rows,
// start_row, lengths, L and W) and run one thread per group of 16
// windows: the thread forms its windows' (hi, lo, valid) in registers
// with the pack's reader (windows16.cuh) and probes them, so no hi, lo or
// valid word is written or read back (9 + 14 bytes per window before).
// The group's 16 outputs of each kind are contiguous, so the mask and the
// found bytes leave as one 16-byte store per thread.
//
// Bound on the H100: random table rows.  The bytes bound (each valid
// window's 32-byte sector at 3.35 TB/s, plus the streaming transfer rows
// and outputs) is not what limits them: random reads of rows of 16 to
// 32 bytes run at about 20-27 G rows/s on this card, whatever their size
// up to a sector, in torch's gather of 20- and 24-byte rows and in these
// kernels alike (chip_smoke.py phase 2; PERF.md).  So the design counts
// random rows, and the kernels read one row per valid window where they
// can:
//
// skt_probe_wide_distance reads "distance rows" (table/wide_table.py:
// distance_rows), built once per MatrixDistance from the probe and aux
// rows: per bucket tag x S | fm x S | var16 pairs x ceil(S/2), padded to
// a multiple of 8 words: 32 bytes, one sector, at 2 slots; 64 at 4, of
// which the first 48 are read.  The filter reads nothing else (function
// and mean are fm's halves, var the low half of v2), so a valid window
// costs one random row, with no second read that waits on the tag
// compare (the aux word was such a read before).  The threads take their
// 16 windows in batches (8 at 2 slots, 4 at 4): every row of a batch is
// requested as 16-byte evict-first loads before any compare.  A miss in
// the main row reads the leaf's distance row (the leaf stays in L2),
// tags 4 at a time, then the matched slot's fm and var words.
//
// skt_probe_wide_aux keeps the table's probe and aux rows (the aux rows
// are the keep-hits path's only extra memory beside the call path's probe
// rows), so a valid window costs two random rows: it requests its main
// row and its whole aux row together and picks the matched slot's words
// after the compare, so a found window waits for one round trip instead
// of two; a miss wastes its aux read.  The device's aux rows are 3*S
// words padded to a multiple of 4 (wide_table.aux_row_words): 32 bytes
// at 2 slots, one sector and two 16-byte loads (24-byte rows cross a
// sector at every other bucket), 48 at 4.  The threads take their
// windows 4 at a time, one 16-byte word of each output per batch; fm,
// r0, r1 and r2 are staged per warp in shared memory (8 KB a warp) and
// leave as 512-byte stores, as the pack's hi and lo do.
// Outputs of both equal the plain versions bit for bit: the aux probe's
// words under found and 0 elsewhere, the mask everywhere.

namespace {

__host__ __device__ constexpr int distance_row_words(int S) {
    return (2 * S + (S + 1) / 2 + 7) / 8 * 8;
}

// The length filter of matrix_distance.py:217-233, bit for bit
struct DistanceFilter {
    int hypo;    // the hypothetical function, or -1
    bool exact;  // the integer form (len_sigma_window 2, frac 0.1)
    float w, frac;

    __device__ __forceinline__ bool ok(int seqlen, int mean,
                                       int var) const {
        const int d = seqlen - mean;
        const int ad = d < 0 ? -d : d;
        if (exact) {
            const int dc = ad < 1024 ? ad : 1024;
            return var == 0 ? 5 * ad <= seqlen : dc * dc <= 4 * var;
        }
        const float stddev = var == 0
                                 ? __fmul_rn(__int2float_rn(seqlen), frac)
                                 : __fsqrt_rn(__int2float_rn(var));
        return fabsf(__int2float_rn(d)) <= __fmul_rn(w, stddev);
    }
};

__device__ __forceinline__ uint32_t word_of(const uint4 &x, int k) {
    return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

// Main distance rows of NB windows: every valid window's row in flight
// before any compare, then f, fm and the matched slot's var16.
template <int SLOTS, int NB>
__device__ __forceinline__ void main_distance(
        const uint4 *__restrict__ drows, uint32_t salt, int bits,
        const uint32_t *h, const uint32_t *l, const bool *v, bool *f,
        uint32_t *fm, uint32_t *var) {
    constexpr int D4 = distance_row_words(SLOTS) / 4;  // 16-byte words
    constexpr int Q = (2 * SLOTS + (SLOTS + 1) / 2 + 3) / 4;  // read
    uint32_t bkt[NB], tag[NB];
#pragma unroll
    for (int i = 0; i < NB; i++)
        bucket_tag(h[i], l[i], salt, bits, bkt[i], tag[i]);
    uint4 row[NB][Q];
#pragma unroll
    for (int i = 0; i < NB; i++)
#pragma unroll
        for (int q = 0; q < Q; q++)
            row[i][q] = v[i] ? __ldcs(drows + (size_t)bkt[i] * D4 + q)
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < NB; i++) {
        f[i] = false;
        fm[i] = var[i] = 0u;
#pragma unroll
        for (int s = 0; s < SLOTS; s++) {
            if (v[i] && word_of(row[i][s / 4], s % 4) == tag[i]) {
                constexpr int V = 2 * SLOTS;  // first var word
                f[i] = true;
                fm[i] = word_of(row[i][(SLOTS + s) / 4], (SLOTS + s) % 4);
                var[i] = word_of(row[i][(V + s / 2) / 4], (V + s / 2) % 4)
                             >> (16 * (s & 1)) & 0xFFFFu;
            }
        }
    }
}

// Leaf distance rows (S slots, D words each, D a multiple of 8) of the
// windows with want[i]: tags read 4 at a time, then the matched slot's fm
// and var words (the leaf stays in L2).
template <int NB>
__device__ __forceinline__ void leaf_distance(
        const uint32_t *__restrict__ ov, int S, int D, uint32_t salt,
        int bits, const uint32_t *h, const uint32_t *l, const bool *want,
        bool *f, uint32_t *fm, uint32_t *var) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < NB; i++) any |= want[i];
    if (!any) return;
    const uint32_t *row[NB];
    uint32_t tag[NB];
    int slot[NB];
#pragma unroll
    for (int i = 0; i < NB; i++) {
        uint32_t bkt;
        bucket_tag(h[i], l[i], salt, bits, bkt, tag[i]);
        row[i] = ov + (size_t)bkt * D;
        slot[i] = -1;
    }
    for (int s = 0; s < S; s += 4) {
        uint4 t[NB];
#pragma unroll
        for (int i = 0; i < NB; i++)
            t[i] = want[i] ? __ldg((const uint4 *)(row[i] + s))
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < NB; i++)
#pragma unroll
            for (int k = 0; k < 4; k++)
                if (want[i] && s + k < S && word_of(t[i], k) == tag[i])
                    slot[i] = s + k;
    }
#pragma unroll
    for (int i = 0; i < NB; i++) {
        if (slot[i] < 0) continue;
        const int sl = slot[i];
        f[i] = true;
        fm[i] = __ldg(row[i] + S + sl);
        var[i] = __ldg(row[i] + 2 * S + sl / 2) >> (16 * (sl & 1)) & 0xFFFFu;
    }
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS) probe_distance_kernel(
        const uint32_t *__restrict__ rows, int R,
        const int32_t *__restrict__ start_row,
        const int32_t *__restrict__ lengths, int L, unsigned G,
        unsigned n_groups, const uint4 *__restrict__ drows, uint32_t salt,
        int bits, const uint32_t *__restrict__ ov_drows, int ov_slots,
        uint32_t ov_salt, int ov_bits, bool has_overflow,
        DistanceFilter filt, uint4 *__restrict__ mask) {
    constexpr int NB = SLOTS == 2 ? 8 : 4;  // windows per batch
    const unsigned t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= n_groups) return;
    const unsigned b = t / G;
    const int g = (int)(t - b * G);
    const int len = lengths[b];
    uint32_t s[5];
    bool tail;
    const uint32_t vbits = windows16::read_group(
        rows, R, (long)start_row[b] + g, g, len, L, s, tail);
    const int ov_words = distance_row_words(ov_slots);
    uint32_t keep = 0u;
#pragma unroll
    for (int w0 = 0; w0 < 16; w0 += NB) {
        if (!(vbits >> w0 & ((1u << NB) - 1u))) continue;
        uint32_t h[NB], l[NB], fm[NB], var[NB];
        bool v[NB], f[NB];
#pragma unroll
        for (int i = 0; i < NB; i++) {
            h[i] = windows16::window_hi(s, tail, w0 + i);
            l[i] = windows16::window_lo(s, tail, w0 + i);
            v[i] = vbits >> (w0 + i) & 1u;
        }
        main_distance<SLOTS, NB>(drows, salt, bits, h, l, v, f, fm, var);
        if (has_overflow) {  // the misses only
            bool miss[NB];
#pragma unroll
            for (int i = 0; i < NB; i++) miss[i] = v[i] && !f[i];
            leaf_distance<NB>(ov_drows, ov_slots, ov_words, ov_salt, ov_bits,
                              h, l, miss, f, fm, var);
        }
#pragma unroll
        for (int i = 0; i < NB; i++) {
            const bool k = v[i] && f[i] && (int)(fm[i] >> 16) != filt.hypo &&
                           filt.ok(len, (int)(fm[i] & 0xFFFFu), (int)var[i]);
            keep |= (uint32_t)k << (w0 + i);
        }
    }
    __stcs(mask + t, windows16::bits_to_bytes(keep));
}

// Main and aux rows of VEC windows, all requested before any compare:
// f, fm and the matched slot's three aux words a[k][i] (0 on a miss).
// Aux rows are v0 x S, v1 x S, v2 x S, padded to AQ 16-byte words.
template <int SLOTS>
__device__ __forceinline__ void main_aux_lookups(
        const uint4 *__restrict__ packed, const uint4 *__restrict__ aux,
        uint32_t salt, int bits, const uint32_t *h, const uint32_t *l,
        const bool *v, bool *f, uint32_t *fm, uint32_t (*a)[VEC]) {
    constexpr int Q = SLOTS / 2;             // 16-byte words per main row
    constexpr int AQ = (3 * SLOTS + 3) / 4;  // 16-byte words per aux row
    uint32_t bkt[VEC], tag[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++)
        bucket_tag(h[i], l[i], salt, bits, bkt[i], tag[i]);
    uint4 row[VEC][Q], x[VEC][AQ];
#pragma unroll
    for (int i = 0; i < VEC; i++) {
#pragma unroll
        for (int q = 0; q < Q; q++)
            row[i][q] = v[i] ? __ldcs(packed + (size_t)bkt[i] * Q + q)
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < AQ; q++)
            x[i][q] = v[i] ? __ldcs(aux + (size_t)bkt[i] * AQ + q)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < VEC; i++) {
        f[i] = false;
        fm[i] = a[0][i] = a[1][i] = a[2][i] = 0u;
#pragma unroll
        for (int s = 0; s < SLOTS; s++) {
            if (v[i] && word_of(row[i][s / 4], s % 4) == tag[i]) {
                f[i] = true;
                fm[i] = word_of(row[i][(SLOTS + s) / 4], (SLOTS + s) % 4);
#pragma unroll
                for (int k = 0; k < 3; k++)
                    a[k][i] = word_of(x[i][(k * SLOTS + s) / 4],
                                      (k * SLOTS + s) % 4);
            }
        }
    }
}

template <int SLOTS>
__global__ void __launch_bounds__(THREADS) probe_aux_kernel(
        const uint32_t *__restrict__ rows, int R,
        const int32_t *__restrict__ start_row,
        const int32_t *__restrict__ lengths, int L, unsigned G,
        unsigned n_groups, const uint4 *__restrict__ packed, uint32_t salt,
        int bits, const uint4 *__restrict__ aux,
        const uint32_t *__restrict__ ov_packed, int ov_slots,
        uint32_t ov_salt, int ov_bits, bool has_overflow,
        const uint32_t *__restrict__ ov_aux, uint4 *__restrict__ found,
        int4 *__restrict__ fm_out, int4 *__restrict__ r0,
        int4 *__restrict__ r1, int4 *__restrict__ r2) {
    // a warp's 32 groups of fm, r0, r1 and r2
    __shared__ int4 stage[THREADS / 32][4][128];
    const unsigned t = blockIdx.x * THREADS + threadIdx.x;
    const unsigned lane = threadIdx.x & 31;
    // a lane past the last group still takes part in its warp's staging
    const bool active = t < n_groups;
    uint32_t s[5] = {0u, 0u, 0u, 0u, 0u}, vbits = 0u;
    bool tail = false;
    if (active) {
        const unsigned b = t / G;
        const int g = (int)(t - b * G);
        vbits = windows16::read_group(rows, R, (long)start_row[b] + g, g,
                                      lengths[b], L, s, tail);
    }
    int4(*w)[128] = stage[threadIdx.x >> 5];
    uint32_t hits = 0u;
#pragma unroll
    for (int k = 0; k < 4; k++) {  // windows 4k .. 4k+3
        uint32_t h[VEC], l[VEC], fm1[VEC], a[3][VEC];
        bool v[VEC], f[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            h[i] = windows16::window_hi(s, tail, 4 * k + i);
            l[i] = windows16::window_lo(s, tail, 4 * k + i);
            v[i] = vbits >> (4 * k + i) & 1u;
        }
        main_aux_lookups<SLOTS>(packed, aux, salt, bits, h, l, v, f, fm1, a);
        bool f2[VEC] = {};
        uint32_t fm2[VEC] = {}, bkt2[VEC] = {};
        int slot2[VEC] = {};
        if (has_overflow) {  // the misses only
            bool miss[VEC];
#pragma unroll
            for (int i = 0; i < VEC; i++) miss[i] = v[i] && !f[i];
            leaf_lookups(ov_packed, ov_slots, ov_salt, ov_bits, h, l, miss,
                         f2, fm2, bkt2, slot2);
        }
        uint32_t fm[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            fm[i] = f[i] ? fm1[i] : f2[i] ? fm2[i] : 0u;
            if (f2[i]) {  // the leaf's aux words (in L2)
                const uint32_t *p =
                    ov_aux + (size_t)bkt2[i] * 3 * ov_slots + slot2[i];
#pragma unroll
                for (int j = 0; j < 3; j++) a[j][i] = __ldg(p + j * ov_slots);
            }
            hits |= (uint32_t)(f[i] || f2[i]) << (4 * k + i);
        }
        windows16::stage_put(w[0], lane, k,
                             make_int4(fm[0], fm[1], fm[2], fm[3]));
#pragma unroll
        for (int j = 0; j < 3; j++)
            windows16::stage_put(w[1 + j], lane, k,
                                 make_int4(a[j][0], a[j][1], a[j][2],
                                           a[j][3]));
    }
    __syncwarp();
    const size_t base = ((size_t)t - lane) * 4, end = (size_t)n_groups * 4;
    int4 *out[4] = {fm_out, r0, r1, r2};
#pragma unroll
    for (int j = 0; j < 4; j++)
        windows16::stage_flush(w[j], lane, base, end, out[j]);
    if (active) __stcs(found + t, windows16::bits_to_bytes(hits));
}

}  // namespace

// The probe with the matched slot's three value words over the first W
// windows of B sequences of transfer rows (W a multiple of 16, 0 < W <=
// L); slots 2 or 4, the main aux rows padded to (3 * slots + 3) / 4
// 16-byte words, every table pointer 16-byte aligned (the wrapper checks
// all three).  found is (B, W) bytes, fm and r0-r2 (B, W) words.
extern "C" int skt_probe_wide_aux(
        const void *rows, int R, const void *start_row, const void *lengths,
        int B, int L, int W, const void *packed, int slots, unsigned salt,
        int bits, const void *aux, const void *ov_packed, int ov_slots,
        unsigned ov_salt, int ov_bits, int has_overflow, const void *ov_aux,
        void *found, void *fm, void *r0, void *r1, void *r2, void *stream) {
    if (slots != 2 && slots != 4) return (int)cudaErrorInvalidValue;
    const long n = (long)B * (W / 16);
    if (n > 0) {
        auto kernel = slots == 2 ? probe_aux_kernel<2> : probe_aux_kernel<4>;
        kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(
            (const uint32_t *)rows, R, (const int32_t *)start_row,
            (const int32_t *)lengths, L, (unsigned)(W / 16), (unsigned)n,
            (const uint4 *)packed, salt, bits, (const uint4 *)aux,
            (const uint32_t *)ov_packed, ov_slots, ov_salt, ov_bits,
            has_overflow != 0, (const uint32_t *)ov_aux, (uint4 *)found,
            (int4 *)fm, (int4 *)r0, (int4 *)r1, (int4 *)r2);
    }
    return (int)cudaGetLastError();
}

// The filtered found mask of matrix distance over the first W windows of
// B sequences of transfer rows, from the distance rows (drows: 2**bits
// rows of distance_row_words(slots) words; ov_drows likewise for the
// leaf).  lengths are the sequence lengths the filter reads; exact
// selects the integer form.
extern "C" int skt_probe_wide_distance(
        const void *rows, int R, const void *start_row, const void *lengths,
        int B, int L, int W, const void *drows, int slots, unsigned salt,
        int bits, const void *ov_drows, int ov_slots, unsigned ov_salt,
        int ov_bits, int has_overflow, int hypo, int exact,
        float len_sigma_window, float zero_var_len_frac, void *mask,
        void *stream) {
    if (slots != 2 && slots != 4) return (int)cudaErrorInvalidValue;
    const long n = (long)B * (W / 16);
    if (n > 0) {
        DistanceFilter filt{hypo, exact != 0, len_sigma_window,
                            zero_var_len_frac};
        auto kernel = slots == 2 ? probe_distance_kernel<2>
                                 : probe_distance_kernel<4>;
        kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(
            (const uint32_t *)rows, R, (const int32_t *)start_row,
            (const int32_t *)lengths, L, (unsigned)(W / 16), (unsigned)n,
            (const uint4 *)drows, salt, bits, (const uint32_t *)ov_drows,
            ov_slots, ov_salt, ov_bits, has_overflow != 0, filt,
            (uint4 *)mask);
    }
    return (int)cudaGetLastError();
}
