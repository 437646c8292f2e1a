// Two-choice cuckoo bucket probe, with or without the value words.
//
// Replaces the XLA program the JAX package builds from ops/probe.py:
// probe_bucket (line 86), with table/bucket_table.py: bucket_hashes
// (:43-52).  One entry point, skt_probe_bucket: with aux NULL it is the
// call path's probe (found, fm); with aux it also returns the matched
// slot's three value words (gather_hits_batch, --debug-hits, matrix
// distance on a cuckoo table).
//
// Table on the device (BucketKmerTable.to_device): n_buckets (a power of
// two) rows of 4*S words, [khi x S | klo x S | fm x S | 0 x S], so that a
// row is whole 32-byte sectors (32 bytes at S = 2, 64 at S = 4; the
// host's rows are 24 and 48 bytes), and beside them aux rows of 4*S
// words, slot-major, [v0, v1, v2, 0] per slot: a slot's value words are
// one 16-byte load inside one sector.  An empty slot holds khi = klo =
// 0xFFFFFFFF, which no 24-bit key word equals.  A key sits in one of its
// two buckets
//   h1 = fmix32(hi ^ fmix32(lo ^ salt)),
//   h2 = fmix32(lo ^ fmix32(hi ^ (salt + 0x9E3779B9)))   (& n_buckets-1).
// Outputs per window, as the JAX masked-sum select gives them (keys are
// unique, so at most one slot matches):
//   fm, r0..r2 = the matched slot's words (row h1 first, then h2) where
//                the key was found and the window is valid, else 0;
//   found      = key found & valid & (fm>>16 != ignore_function).
//
// Bound on the H100: random rows.  A valid window reads row h1 (one
// sector at S = 2; with 24-byte rows a quarter of the buckets straddled
// two, 1.5 sectors a row on average) and row h2 only when h1 missed,
// since a key sits in one bucket only; with aux one 16-byte aux read at
// the winning slot of a found window.  The streaming part is 9 bytes in
// and 5 out per window (12 more out with aux).  The hashes are a few
// dozen integer operations.  Design, so that each thread keeps several
// independent reads in flight:
// - four windows a thread (16-byte loads and stores of the streams,
//   evict-first);
// - all four h1 rows are requested before any is compared, then the h2
//   rows of the windows that missed, together, then the aux reads of the
//   found ones, together; a row's pad words are not read;
// - rows and aux reads go evict-first (__ldcs): each is used once;
//   an invalid window reads no row.
// On the H100 one window a thread, and the same design on the 24-byte
// rows, each measured slower (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 4;  // windows per thread
constexpr int THREADS = 128;

// The windows 4t .. 4t+3 of thread t.  When all four exist ("whole"),
// hi and lo arrive as one 16-byte load each and valid as one 4-byte load,
// and each output leaves as one 16-byte (words) or 4-byte (found) store;
// the thread that holds the n % 4 tail goes one window at a time.  The
// streams are read and written once, so they go evict-first (__ldcs,
// __stcs).  v is false past n.  -> whole
__device__ __forceinline__ bool load_windows(
        const uint32_t *__restrict__ hi, const uint32_t *__restrict__ lo,
        const uint8_t *__restrict__ valid, long n, long t, uint32_t *h,
        uint32_t *l, bool *v) {
    const long base = t * VEC;
    const bool whole = base + VEC <= n;
    if (whole) {
        const uint4 a = __ldcs((const uint4 *)hi + t);
        const uint4 b = __ldcs((const uint4 *)lo + t);
        const uchar4 q = __ldcs((const uchar4 *)valid + t);
        h[0] = a.x, h[1] = a.y, h[2] = a.z, h[3] = a.w;
        l[0] = b.x, l[1] = b.y, l[2] = b.z, l[3] = b.w;
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            const bool in = base + i < n;
            h[i] = in ? hi[base + i] : 0u;
            l[i] = in ? lo[base + i] : 0u;
            v[i] = in && valid[base + i];
        }
    }
    return whole;
}

__device__ __forceinline__ void store_found(uint8_t *__restrict__ out,
                                            long n, long t, bool whole,
                                            const bool *f) {
    if (whole) {
        __stcs((uchar4 *)out + t, make_uchar4(f[0], f[1], f[2], f[3]));
        return;
    }
    for (int i = 0; i < VEC; i++)
        if (t * VEC + i < n) out[t * VEC + i] = f[i];
}

__device__ __forceinline__ void store_words(uint32_t *__restrict__ out,
                                            long n, long t, bool whole,
                                            const uint32_t *w) {
    if (whole) {
        __stcs((uint4 *)out + t, make_uint4(w[0], w[1], w[2], w[3]));
        return;
    }
    for (int i = 0; i < VEC; i++)
        if (t * VEC + i < n) out[t * VEC + i] = w[i];
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// the words of one padded row that the probe reads: keys and fm
template <int S>
struct Row;

template <>
struct Row<2> {  // one sector: (khi0, khi1, klo0, klo1), (fm0, fm1), pad
    uint4 k;
    uint2 f;
    __device__ void load(const uint4 *p) {
        k = __ldcs(p);
        f = __ldcs((const uint2 *)(p + 1));
    }
    __device__ uint32_t khi(int s) const { return s ? k.y : k.x; }
    __device__ uint32_t klo(int s) const { return s ? k.w : k.z; }
    __device__ uint32_t fm(int s) const { return s ? f.y : f.x; }
};

template <>
struct Row<4> {  // two sectors: khi x 4, klo x 4 | fm x 4, pad
    uint4 kh, kl, f;
    __device__ void load(const uint4 *p) {
        kh = __ldcs(p);
        kl = __ldcs(p + 1);
        f = __ldcs(p + 2);
    }
    __device__ static uint32_t at(const uint4 &q, int s) {
        return s == 0 ? q.x : s == 1 ? q.y : s == 2 ? q.z : q.w;
    }
    __device__ uint32_t khi(int s) const { return at(kh, s); }
    __device__ uint32_t klo(int s) const { return at(kl, s); }
    __device__ uint32_t fm(int s) const { return at(f, s); }
};

// the slot of row w whose key is (hi, lo), or -1
template <int S>
__device__ __forceinline__ int match(const Row<S> &w, uint32_t hi,
                                     uint32_t lo) {
    int slot = -1;
#pragma unroll
    for (int s = S - 1; s >= 0; s--)
        if (w.khi(s) == hi && w.klo(s) == lo) slot = s;
    return slot;
}

template <int S, bool AUX>
__global__ void __launch_bounds__(THREADS) probe_bucket_kernel(
        const uint32_t *__restrict__ hi, const uint32_t *__restrict__ lo,
        const uint8_t *__restrict__ valid, long n,
        const uint4 *__restrict__ packed, uint32_t mask, uint32_t salt,
        const uint4 *__restrict__ aux, int ignore_function,
        uint8_t *__restrict__ found, uint32_t *__restrict__ fm,
        uint32_t *__restrict__ r0, uint32_t *__restrict__ r1,
        uint32_t *__restrict__ r2) {
    const long t = (long)blockIdx.x * THREADS + threadIdx.x;
    if (t * VEC >= n) return;
    uint32_t h[VEC], l[VEC];
    bool v[VEC];
    const bool whole = load_windows(hi, lo, valid, n, t, h, l, v);

    // row h1 of every valid window, all in flight before any compare
    uint32_t b[VEC];
    int slot[VEC];
    Row<S> row[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++) {
        b[i] = fmix32(h[i] ^ fmix32(l[i] ^ salt)) & mask;
        if (v[i]) row[i].load(packed + (size_t)b[i] * S);
    }
    bool again = false;
#pragma unroll
    for (int i = 0; i < VEC; i++) {
        slot[i] = v[i] ? match<S>(row[i], h[i], l[i]) : -1;
        again |= v[i] && slot[i] < 0;
    }
    // row h2 of the windows that missed row h1, together
    if (again) {
        bool miss[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            miss[i] = v[i] && slot[i] < 0;
            if (miss[i]) {
                b[i] = fmix32(l[i] ^ fmix32(h[i] ^ (salt + 0x9E3779B9u))) &
                       mask;
                row[i].load(packed + (size_t)b[i] * S);
            }
        }
#pragma unroll
        for (int i = 0; i < VEC; i++)
            if (miss[i]) slot[i] = match<S>(row[i], h[i], l[i]);
    }

    uint32_t w[4][VEC];  // fm, then with AUX v0, v1, v2
#pragma unroll
    for (int i = 0; i < VEC; i++)
        w[0][i] = slot[i] >= 0 ? row[i].fm(slot[i]) : 0u;
    if constexpr (AUX) {
        uint4 a[VEC];
#pragma unroll
        for (int i = 0; i < VEC; i++)
            a[i] = slot[i] >= 0 ? __ldcs(aux + (size_t)b[i] * S + slot[i])
                                : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < VEC; i++) {
            w[1][i] = a[i].x;
            w[2][i] = a[i].y;
            w[3][i] = a[i].z;
        }
    }

    bool fo[VEC];
#pragma unroll
    for (int i = 0; i < VEC; i++)
        fo[i] = slot[i] >= 0 && (int)(w[0][i] >> 16) != ignore_function;
    store_found(found, n, t, whole, fo);
    store_words(fm, n, t, whole, w[0]);
    if constexpr (AUX) {
        store_words(r0, n, t, whole, w[1]);
        store_words(r1, n, t, whole, w[2]);
        store_words(r2, n, t, whole, w[3]);
    }
}

template <int S>
void launch(long n, cudaStream_t stream, const void *hi, const void *lo,
            const void *valid, const void *packed, unsigned mask,
            unsigned salt, const void *aux, int ignore_function, void *found,
            void *fm, void *r0, void *r1, void *r2) {
    const long blocks = ((n + VEC - 1) / VEC + THREADS - 1) / THREADS;
    auto kernel = aux ? probe_bucket_kernel<S, true>
                      : probe_bucket_kernel<S, false>;
    kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const uint32_t *)hi, (const uint32_t *)lo, (const uint8_t *)valid,
        n, (const uint4 *)packed, mask, salt, (const uint4 *)aux,
        ignore_function, (uint8_t *)found, (uint32_t *)fm, (uint32_t *)r0,
        (uint32_t *)r1, (uint32_t *)r2);
}

}  // namespace

// n windows (hi, lo int32 words, valid bytes) against a table of
// n_buckets padded rows of 4*slots words; aux NULL: no value words
// (r0..r2 may be NULL), else the slot-major aux rows.  Every pointer
// 16-byte aligned, the tables 32-byte aligned (the wrapper checks).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a slot count
// other than 2 or 4 or a bucket count not a power of two.
extern "C" int skt_probe_bucket(const void *hi, const void *lo,
                                const void *valid, long n, const void *packed,
                                int slots, unsigned n_buckets, unsigned salt,
                                const void *aux, int ignore_function,
                                void *found, void *fm, void *r0, void *r1,
                                void *r2, void *stream) {
    if ((slots != 2 && slots != 4) || n_buckets == 0 ||
        (n_buckets & (n_buckets - 1)))
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        auto go = slots == 2 ? launch<2> : launch<4>;
        go(n, (cudaStream_t)stream, hi, lo, valid, packed, n_buckets - 1u,
           salt, aux, ignore_function, found, fm, r0, r1, r2);
    }
    return (int)cudaGetLastError();
}
