// Calling automaton + record packing, one thread per sequence.
//
// Replaces the XLA programs of the JAX package's ops/automaton.py:
// device_automaton (lines 43-223: a lax.scan over positions, then
// per-record statistics by counting binary search) and pack_records
// (lines 240-268), fused: the thread writes the packed block
// [n_recs | start<<16|end x C | count<<16|fI x C | median<<16|mad*4 x C]
// (C = REC_CAP = 4) directly.
//
// Pass A walks the sequence's windows in order and applies the gap flush
// (max_gap), the fresh-buffer adopt, the keep-last-two function switch and
// the tail flush, keeping the first REC_CAP records (function, first
// position, last position) and counting all of them.
// Pass B, per record: members are hits in [start, end] with the record's
// function; count, sum of means, the exact lower/upper medians of the means
// and of |2*mean - 2*median| (the same counting binary search as the XLA
// program, over a compact per-thread list), the MAD floor and the length
// window.  The float32 arithmetic is the XLA program's, operation for
// operation: built with -fmad=false and without fast math, so
// mean - len_window*mad rounds twice like the plain version.
// The epilogue applies pack_records' exactness guards: a length above
// 65535, or an emitted mad*4 that is not an integer or exceeds 65535, sets
// n_recs = REC_CAP + 1 so the host re-calls the row exactly.
//
// Bound on the H100: bytes in principle (5 bytes read per window, 52 bytes
// written per sequence), but the scan is sequential within a sequence, so
// in this first version the time goes to per-thread latency: B threads
// (8192 per chunk on the main path) walk W positions each.  Design: found
// and fm stay row-major as the probe writes them; each thread's member
// list lives in a (W, B) scratch array, so the 34 counting passes of pass
// B read it coalesced across the warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int REC_CAP = 4;
constexpr int PACKED_WORDS = 1 + 3 * REC_CAP;
constexpr int UNDEF = 0xFFFF;

// x1 = the k1-th smallest member value, x2 = the k2-th (k2 <= k1 + 1):
// the XLA program's counting binary search over [0, 2^bits), literally,
// including its results for an empty member list.
__device__ void kth_pair(const int32_t *vals, long stride, int cnt, int k1,
                         int k2, int bits, int &x1, int &x2) {
    int lo = 0, hi = (1 << bits) - 1;
    for (int it = 0; it < bits; it++) {
        int mid = (lo + hi) >> 1;
        int n_le = 0;
        for (int i = 0; i < cnt; i++) n_le += vals[i * stride] <= mid;
        if (n_le >= k1) hi = mid; else lo = mid + 1;
    }
    x1 = hi;
    int n_le1 = 0, x_next = 1 << 30;
    for (int i = 0; i < cnt; i++) {
        int v = vals[i * stride];
        n_le1 += v <= x1;
        if (v > x1 && v < x_next) x_next = v;
    }
    x2 = n_le1 >= k2 ? x1 : x_next;
}

__device__ __forceinline__ int32_t u16pair(uint32_t hi, uint32_t lo) {
    return (int32_t)((hi << 16) | (lo & 0xFFFFu));
}

__global__ void automaton_kernel(
        const uint8_t *__restrict__ found, const uint32_t *__restrict__ fm,
        const int32_t *__restrict__ lengths, int B, int W, int min_hits,
        int max_gap, int k, float mad_floor, float len_window,
        int32_t *__restrict__ scratch, int32_t *__restrict__ out) {
    int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const uint8_t *fr = found + (long)b * W;
    const uint32_t *fmr = fm + (long)b * W;

    // ---- pass A ----------------------------------------------------------
    int cur = UNDEF, n = 0, first = 0, lpos = -(1 << 30);
    int lfunc = UNDEF, l2func = UNDEF, l2pos = 0, nrec = 0;
    int rec_f[REC_CAP], rec_ps[REC_CAP], rec_pe[REC_CAP];
    auto emit = [&](int f, int ps, int pe) {
        if (nrec < REC_CAP) {
            rec_f[nrec] = f;
            rec_ps[nrec] = ps;
            rec_pe[nrec] = pe;
        }
        nrec++;
    };
    for (int p = 0; p < W; p++) {
        if (!fr[p]) continue;
        int f = (int)((fmr[p] >> 16) & 0xFFFFu);
        if (n > 0 && lpos + max_gap < p) {  // gap flush
            if (n >= min_hits) {
                emit(cur, first, lpos);
                if (n >= 2 && l2func != cur && l2func == lfunc) {
                    cur = lfunc;
                    first = l2pos;
                    n = 2;
                } else {
                    n = 0;
                }
            } else {
                n = 0;
            }
        }
        if (n == 0) {  // empty buffer adopts the hit's function
            cur = f;
            first = p;
        }
        l2func = lfunc;  // append
        l2pos = lpos;
        lfunc = f;
        lpos = p;
        n++;
        if (n > 1 && cur != f && l2func == lfunc) {  // same-function pair
            emit(cur, first, p);
            cur = f;
            first = l2pos;
            n = 2;
        }
    }
    if (n >= min_hits) emit(cur, first, lpos);  // tail flush

    // ---- pass B + packing ------------------------------------------------
    int32_t *o = out + (long)b * PACKED_WORDS;
    int32_t *vals = scratch + b;  // column b of the (W, B) scratch
    int seqlen = lengths[b];
    float sl = (float)seqlen;
    bool bad = seqlen > 65535;
    for (int r = 0; r < REC_CAP; r++) {
        int32_t se = 0, cf = 0, mm = 0;
        if (r < nrec) {
            int fI = rec_f[r], ps = rec_ps[r], pe = rec_pe[r];
            int cnt = 0, last = -1;
            uint32_t msum = 0;
            for (int p = ps > 0 ? ps : 0; p <= pe && p < W; p++) {
                if (fr[p] && (int)((fmr[p] >> 16) & 0xFFFFu) == fI) {
                    int mean = (int)(fmr[p] & 0xFFFFu);
                    vals[(long)cnt * B] = mean;
                    cnt++;
                    msum += (uint32_t)mean;
                    last = p;
                }
            }
            int safe = cnt > 1 ? cnt : 1;
            int k1 = (safe - 1) / 2 + 1, k2 = safe / 2 + 1;
            int m_lo, m_hi, d_lo, d_hi;
            kth_pair(vals, B, cnt, k1, k2, 16, m_lo, m_hi);
            int med2 = m_lo + m_hi;
            for (int i = 0; i < cnt; i++) {
                int d = 2 * vals[(long)i * B] - med2;
                vals[(long)i * B] = d < 0 ? -d : d;
            }
            kth_pair(vals, B, cnt, k1, k2, 18, d_lo, d_hi);
            float median = (float)med2 / 2.0f;
            float mad = (float)(d_lo + d_hi) / 4.0f;
            if (mad == 0.0f) mad = mad_floor;
            float mean_len = (float)(int32_t)msum / (float)safe;
            float span = len_window * mad;
            bool emit_call = cnt >= min_hits && sl >= mean_len - span
                && sl <= mean_len + span;
            if (emit_call) {
                float mad4f = mad * 4.0f;
                if (mad4f > 65535.0f || rintf(mad4f) != mad4f) bad = true;
                int mad4 = (int)rintf(fminf(fmaxf(mad4f, 0.0f), 65535.0f));
                se = u16pair((uint32_t)ps, (uint32_t)(last + (k - 1)));
                cf = u16pair((uint32_t)cnt, (uint32_t)fI);
                mm = u16pair((uint32_t)(int)median, (uint32_t)mad4);
            }
        }
        o[1 + r] = se;
        o[1 + REC_CAP + r] = cf;
        o[1 + 2 * REC_CAP + r] = mm;
    }
    o[0] = bad ? REC_CAP + 1 : nrec;
}

}  // namespace

extern "C" int skt_automaton_packed(const void *found, const void *fm,
                                    const void *lengths, int B, int W,
                                    int min_hits, int max_gap, int k,
                                    float mad_floor, float len_window,
                                    void *scratch, void *out, void *stream) {
    if (B > 0) {
        int threads = 128;
        int blocks = (B + threads - 1) / threads;
        automaton_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t *)found, (const uint32_t *)fm,
            (const int32_t *)lengths, B, W, min_hits, max_gap, k, mad_floor,
            len_window, (int32_t *)scratch, (int32_t *)out);
    }
    return (int)cudaGetLastError();
}
