// Calling automaton + record packing, one warp per sequence.
//
// Replaces the XLA programs of the JAX package's ops/automaton.py:
// device_automaton (lines 43-223: a lax.scan over positions, then
// per-record statistics by counting binary search) and pack_records
// (lines 240-268), fused: the warp writes the packed block
// [n_recs | start<<16|end x C | count<<16|fI x C | median<<16|mad*4 x C]
// (C = REC_CAP = 4) directly.
//
// Pass A walks the sequence's windows in order and applies the gap flush
// (max_gap), the fresh-buffer adopt, the keep-last-two function switch and
// the tail flush, keeping the first REC_CAP records (function, first
// position, last position) and counting all of them.
// Pass B, per record: members are hits in [start, end] with the record's
// function; count, sum of means, the exact lower/upper medians of the means
// and of |2*mean - 2*median|, the MAD floor and the length window.  The
// float32 arithmetic is the XLA program's, operation for operation: built
// with -fmad=false and without fast math, so mean - len_window*mad rounds
// twice like the plain version.
// The epilogue applies pack_records' exactness guards: a length above
// 65535, or an emitted mad*4 that is not an integer or exceeds 65535, sets
// n_recs = REC_CAP + 1 so the host re-calls the row exactly.
//
// Bound on the H100: bytes in principle (5 bytes read per window, 52 bytes
// written per sequence); in practice instruction issue, because pass A is
// sequential within a sequence and real rows are dense (about 230 hits in
// 304 windows on a uniform chunk).  Design:
// - one warp per sequence (B warps, 8 per block), so a chunk of 8192 rows
//   fills every SM and each row's found/fm loads are coalesced: the lanes
//   read 32 consecutive windows per step, one step ahead of their use;
// - pass A: __ballot_sync gives the step's hit mask, and every lane runs the
//   same state machine over the set bits in order, taking each hit's
//   function from its lane with __shfl_sync.  The state is warp-uniform:
//   no divergence and no shared memory.  Lane r keeps record r;
// - pass B strides the lanes over each record's interval, which the warp
//   has just read (L1/L2), and reduces count, sum, last member and the
//   value range with warp reductions.  The XLA program's counting binary
//   search makes 36 counting passes per record (16 + 1 over the means,
//   18 + 1 over the deviations); here the search runs over the members'
//   own value range [min, max] instead of [0, 2^bits), which selects the
//   same k-th values in ceil(log2(max - min + 1)) passes (none when all
//   members share one mean), each one warp reduction per 32 positions.
//   The upper median reuses the count the search already made and needs
//   one more pass only when it differs from the lower one;
// - records with fewer than min_hits members are neither emitted nor able
//   to set the guard flag, so their statistics are not computed;
// - no scratch: a row of any length W streams through the warp.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int REC_CAP = 4;
constexpr int PACKED_WORDS = 1 + 3 * REC_CAP;
constexpr int UNDEF = 0xFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 8;  // sequences per block

__device__ __forceinline__ int32_t u16pair(uint32_t hi, uint32_t lo) {
    return (int32_t)((hi << 16) | (lo & 0xFFFFu));
}

// One record's members: hits in [lo_p, hi_p] of the row whose function is
// fI.  A member's value is its mean, or |2*mean - med2| when med2 >= 0.
struct Members {
    const uint8_t *fr;
    const uint32_t *fmr;
    int lo_p, hi_p, fI, lane;

    __device__ __forceinline__ bool at(int p, int med2, int &v) const {
        uint32_t w = fmr[p];
        v = (int)(w & 0xFFFFu);
        if (med2 >= 0) v = abs(2 * v - med2);
        return fr[p] && (int)(w >> 16) == fI;
    }

    // members with value <= x, summed over the warp
    __device__ int count_le(int med2, int x) const {
        int c = 0, v;
        for (int p = lo_p + lane; p <= hi_p; p += 32)
            c += at(p, med2, v) && v <= x;
        return (int)__reduce_add_sync(FULL, (unsigned)c);
    }

    // the smallest member value above x (1 << 30 if none)
    __device__ int next_above(int med2, int x) const {
        int m = 1 << 30, v;
        for (int p = lo_p + lane; p <= hi_p; p += 32)
            if (at(p, med2, v) && v > x && v < m) m = v;
        return __reduce_min_sync(FULL, m);
    }

    // x1 = the k1-th smallest member value, x2 = the k2-th (k2 <= k1 + 1),
    // for values known to lie in [lo, hi], n_hi of them <= hi: the smallest
    // x with at least k1 members <= x, by bisection of [lo, hi]
    __device__ void kth_pair(int med2, int lo, int hi, int n_hi, int k1,
                             int k2, int &x1, int &x2) const {
        while (lo < hi) {
            int mid = (lo + hi) >> 1;
            int c = count_le(med2, mid);
            if (c >= k1) {
                hi = mid;
                n_hi = c;
            } else {
                lo = mid + 1;
            }
        }
        x1 = hi;
        x2 = n_hi >= k2 ? x1 : next_above(med2, x1);
    }
};

__global__ void __launch_bounds__(WARPS * 32) automaton_kernel(
        const uint8_t *__restrict__ found, const uint32_t *__restrict__ fm,
        const int32_t *__restrict__ lengths, int B, int W, int min_hits,
        int max_gap, int k, float mad_floor, float len_window,
        int32_t *__restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long b = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // warp-uniform
    const uint8_t *fr = found + b * W;
    const uint32_t *fmr = fm + b * W;

    // ---- pass A ----------------------------------------------------------
    int cur = UNDEF, n = 0, first = 0, lpos = -(1 << 30);
    int lfunc = UNDEF, l2func = UNDEF, l2pos = 0, nrec = 0;
    int rec_f = 0, rec_ps = 0, rec_pe = 0;  // lane r keeps record r
    auto emit = [&](int f, int ps, int pe) {
        if (lane == nrec) {
            rec_f = f;
            rec_ps = ps;
            rec_pe = pe;
        }
        nrec++;
    };
    bool h_next = lane < W && fr[lane];
    uint32_t m_next = lane < W ? fmr[lane] : 0u;
    for (int p0 = 0; p0 < W; p0 += 32) {
        unsigned hits = __ballot_sync(FULL, h_next);
        int my_func = (int)(m_next >> 16);
        int pn = p0 + 32 + lane;  // load the next step before this one runs
        h_next = pn < W && fr[pn];
        m_next = pn < W ? fmr[pn] : 0u;
        while (hits) {
            int j = __ffs(hits) - 1;
            hits &= hits - 1;
            int f = __shfl_sync(FULL, my_func, j);
            int p = p0 + j;
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
    }
    if (n >= min_hits) emit(cur, first, lpos);  // tail flush

    // ---- pass B + packing ------------------------------------------------
    const int seqlen = lengths[b];
    const float sl = (float)seqlen;
    bool bad = seqlen > 65535;
    int32_t se = 0, cf = 0, mm = 0;  // lane r packs record r
    const int kept = nrec < REC_CAP ? nrec : REC_CAP;
    for (int r = 0; r < kept; r++) {
        Members mem{fr, fmr, 0, 0, __shfl_sync(FULL, rec_f, r), lane};
        const int ps = __shfl_sync(FULL, rec_ps, r);
        mem.lo_p = ps > 0 ? ps : 0;
        mem.hi_p = min(__shfl_sync(FULL, rec_pe, r), W - 1);
        int cnt = 0, last = -1, vmin = INT_MAX, vmax = -1, v;
        uint32_t msum = 0;
        for (int p = mem.lo_p + lane; p <= mem.hi_p; p += 32) {
            if (mem.at(p, -1, v)) {
                cnt++;
                msum += (uint32_t)v;
                last = p;
                vmin = min(vmin, v);
                vmax = max(vmax, v);
            }
        }
        cnt = (int)__reduce_add_sync(FULL, (unsigned)cnt);
        if (cnt < min_hits) continue;  // not emitted, cannot set the guard
        msum = __reduce_add_sync(FULL, msum);
        last = __reduce_max_sync(FULL, last);
        vmin = __reduce_min_sync(FULL, vmin);
        vmax = __reduce_max_sync(FULL, vmax);
        int safe = cnt > 1 ? cnt : 1;
        int k1 = (safe - 1) / 2 + 1, k2 = safe / 2 + 1;
        // the XLA search's results for an empty member list (a record
        // always holds the hit that opened it, so only min_hits <= 0 with
        // an empty row reaches them)
        int m_lo = 0xFFFF, m_hi = 1 << 30, d_lo = 0x3FFFF, d_hi = 1 << 30;
        if (cnt > 0) mem.kth_pair(-1, vmin, vmax, cnt, k1, k2, m_lo, m_hi);
        const int med2 = m_lo + m_hi;  // exact 2*median
        if (cnt > 0)  // deviations lie in [0, the larger distance to an end]
            mem.kth_pair(med2, 0, max(2 * vmax - med2, med2 - 2 * vmin), cnt,
                         k1, k2, d_lo, d_hi);
        float median = (float)med2 / 2.0f;
        float mad = (float)(d_lo + d_hi) / 4.0f;
        if (mad == 0.0f) mad = mad_floor;
        float mean_len = (float)(int32_t)msum / (float)safe;
        float span = len_window * mad;
        if (sl >= mean_len - span && sl <= mean_len + span) {
            float mad4f = mad * 4.0f;
            if (mad4f > 65535.0f || rintf(mad4f) != mad4f) bad = true;
            int mad4 = (int)rintf(fminf(fmaxf(mad4f, 0.0f), 65535.0f));
            if (lane == r) {
                se = u16pair((uint32_t)ps, (uint32_t)(last + (k - 1)));
                cf = u16pair((uint32_t)cnt, (uint32_t)mem.fI);
                mm = u16pair((uint32_t)(int)median, (uint32_t)mad4);
            }
        }
    }
    int32_t *o = out + b * PACKED_WORDS;
    if (lane < REC_CAP) {
        o[1 + lane] = se;
        o[1 + REC_CAP + lane] = cf;
        o[1 + 2 * REC_CAP + lane] = mm;
    }
    if (lane == 0) o[0] = bad ? REC_CAP + 1 : nrec;
}

}  // namespace

extern "C" int skt_automaton_packed(const void *found, const void *fm,
                                    const void *lengths, int B, int W,
                                    int min_hits, int max_gap, int k,
                                    float mad_floor, float len_window,
                                    void *out, void *stream) {
    if (B > 0) {
        int blocks = (B + WARPS - 1) / WARPS;
        automaton_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
            (const uint8_t *)found, (const uint32_t *)fm,
            (const int32_t *)lengths, B, W, min_hits, max_gap, k, mad_floor,
            len_window, (int32_t *)out);
    }
    return (int)cudaGetLastError();
}
