// The 6-bit transfer-row reader shared by the window pack
// (pack_call_windows.cu) and the fused probes (probe_wide.cu): one thread
// per group of 16 windows forms each window's (hi, lo, valid) in
// registers from five row words.
//
// Input: the host's transfer rows, 16 codes of 6 bits MSB-first in three
// uint32 words per row.  Code j of sequence b sits in row
// clamp(start_row[b] + j / 16, 0, R - 1) and reads INVALID (63) from
// position lengths[b] on.  For window p < W:
//   hi    = c[p]<<18 | c[p+1]<<12 | c[p+2]<<6 | c[p+3]      (24 bits)
//   lo    = c[p+4]<<18 | ... | c[p+7]                       (24 bits)
//   valid = no '*' (52) or uppercase 'X' (23) in c[p..p+8] (c[p+8] only
//           when p+8 < L) and p+8 <= length.
// Past L the words take the XLA program's shift fills (INVALID for the
// first code shift, 0 for the word shifts), so hi and lo are defined
// everywhere and equal the plain version bit for bit.
//
// Group g of a sequence covers windows 16g..16g+15, whose 24 codes lie in
// rows g and g+1: the thread loads five words, sets the bits of the codes
// past the length, and cuts every 24-bit word out of the 160-bit stream
// with one funnel shift (window_hi, window_lo).

#pragma once

#include <cstdint>

namespace windows16 {

constexpr uint32_t STAR = 52, X_UPPER = 23;

// 32 bits of the MSB-first stream s from bit o on.  o is a constant once
// the loops are unrolled, so this is one funnel shift, a shift or a move.
__device__ __forceinline__ uint32_t bits32(const uint32_t (&s)[5], int o) {
    const int q = o >> 5, r = o & 31;
    if (r == 0) return s[q];
    if (q == 4) return s[4] << r;
    return __funnelshift_l(s[q + 1], s[q], r);
}

// A word's bits from its MSB-first bit t on (all of them for t <= 0).
__device__ __forceinline__ uint32_t ones_from(int t) {
    return t <= 0 ? ~0u : t >= 32 ? 0u : ~0u >> t;
}

// Group g of a sequence of length len, whose codes 16g.. sit in row r
// (start_row + g): the code stream s of its 24 codes, tail (the group
// reaches L, only when W == L) and the return value, bit i set when
// window 16g + i is valid.
__device__ __forceinline__ uint32_t read_group(
        const uint32_t *__restrict__ rows, int R, long r, int g, int len,
        int L, uint32_t (&s)[5], bool &tail) {
    // only when W == L: positions from 16g + 16 on lie past L
    tail = 16 * (g + 1) >= L;
    const long r0 = r < 0 ? 0 : r > R - 1 ? R - 1 : r;
    s[0] = rows[3 * r0];
    s[1] = rows[3 * r0 + 1];
    s[2] = rows[3 * r0 + 2];
    s[3] = s[4] = 0u;
    if (!tail) {
        const long r1 = r + 1 < 0 ? 0 : r + 1 > R - 1 ? R - 1 : r + 1;
        s[3] = rows[3 * r1];
        s[4] = rows[3 * r1 + 1];
    }
    // codes from the sequence's length on read INVALID: set their bits
    const int cut = 6 * max(0, min(len - 16 * g, 24));
#pragma unroll
    for (int k = 0; k < 5; k++) s[k] |= ones_from(cut - 32 * k);
    if (tail) {
        // past L: the first code shift fills INVALID, the word shifts 0
        s[3] = 63u << 26;
        s[4] = 0u;
    }

    // bit i: code i of the 24 is '*' or 'X'
    uint32_t bad = 0;
#pragma unroll
    for (int i = 0; i < 24; i++) {
        const uint32_t c = bits32(s, 6 * i) >> 26;
        bad |= (uint32_t)(c == STAR || c == X_UPPER) << i;
    }
    // bit i: an ambiguous code among codes i..i+8
    uint32_t amb = bad | bad >> 1;
    amb |= amb >> 2;
    amb |= amb >> 4;
    amb |= bad >> 8;
    // windows with p + 8 <= min(length, L)
    const int n_in = max(0, min(min(len, L) - 16 * g - 7, 16));
    return ~amb & ((1u << n_in) - 1u);
}

// hi of window i of the group: the 24 bits from code i
__device__ __forceinline__ uint32_t window_hi(const uint32_t (&s)[5],
                                              bool tail, int i) {
    uint32_t x = bits32(s, 6 * i) >> 8;
    // the word shift's 0 past L: window 14 keeps two codes
    if (tail && i == 14) x &= 0xFFF000u;
    return x;
}

// lo of window i of the group: the 24 bits from code i + 4
__device__ __forceinline__ uint32_t window_lo(const uint32_t (&s)[5],
                                              bool tail, int i) {
    uint32_t x = bits32(s, 6 * i + 24) >> 8;
    // past L: window 10 keeps two codes, and lo is 0 from window 12 on
    if (tail && i == 10) x &= 0xFFF000u;
    if (tail && i >= 12) x = 0u;
    return x;
}

// 16 bits to 16 bytes of 0/1 (bit i to byte i), 4 bits at a time by one
// multiply each
__device__ __forceinline__ uint4 bits_to_bytes(uint32_t bits) {
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; k++)
        v[k] = ((bits >> (4 * k)) & 15u) * 0x00204081u & 0x01010101u;
    return make_uint4(v[0], v[1], v[2], v[3]);
}

// Warp-staged 16-byte stores: a warp's 32 threads each hold 64 bytes,
// words k = 0..3, for 16-byte words 4t..4t+3 of out (t the thread's
// group).  Each thread puts its words into the warp's 2 KB of shared
// memory w (stage_put), then, after __syncwarp(), stage_flush stores
// them so that each store instruction covers 512 contiguous bytes
// instead of 32 pieces 64 bytes apart.  Slot (lane, k) sits at
// lane * 4 + (k ^ (lane >> 1 & 3)): the 8 lanes of a 128-byte phase
// write distinct banks, and 8 lanes reading 128 contiguous bytes too.
// Every lane of the warp takes part (a lane past the last group too);
// words from end on are not stored.
__device__ __forceinline__ void stage_put(int4 *w, unsigned lane, int k,
                                          int4 v) {
    w[lane * 4 + (k ^ (lane >> 1 & 3))] = v;
}

__device__ __forceinline__ void stage_flush(const int4 *w, unsigned lane,
                                            size_t base, size_t end,
                                            int4 *__restrict__ out) {
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const unsigned i = 32 * k + lane, src = i >> 2;
        if (base + i < end)
            out[base + i] = w[src * 4 + ((i & 3) ^ (src >> 1 & 3))];
    }
}

}  // namespace windows16
