// Native host runtime for signature_kmers_tpu.
//
// Two hot host-side pieces the Python layer delegates here:
//
//  1. skt_scan_fasta — buffered FASTA scan producing array-shaped output
//     (6-bit residue codes + offsets + id/defline heaps) for zero-copy
//     feed to the device pipelines.  Semantics mirror the reference's
//     char DFA (ref: fasta_parser.h:38-144) as specified in io/fasta.py.
//
//  2. skt_automaton — the exact sequential per-sequence hit automaton
//     (ref: call_functions.tcc:35-103,259-338), run over device-gathered
//     hit arrays.  Double-precision statistics match the behavioral spec
//     (golden/call.py) bit-for-bit.
//
// Built as a plain C ABI shared library; bound via ctypes (no pybind11 in
// this environment).

#include <algorithm>
#include <array>
#include <atomic>
#include <memory>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

// worker thread count for the parallel table placement: SKT_THREADS env
// override, else hardware concurrency capped at 8 (shared hosts)
static int skt_threads() {
    const char *e = getenv("SKT_THREADS");
    if (e) {
        int v = atoi(e);
        if (v > 0) return v > 64 ? 64 : v;
    }
    unsigned hc = std::thread::hardware_concurrency();
    return hc ? (int)(hc < 8u ? hc : 8u) : 1;
}

extern "C" {

// ---------------------------------------------------------------------------
// FASTA scanner
// ---------------------------------------------------------------------------

// Returns the number of sequences parsed (<= capacity bounds guaranteed:
// n_codes <= n, id/def heaps <= n bytes, n_seqs <= n/2 + 1).
// code_off/id_off/def_off each hold n_seqs+1 entries.
long skt_scan_fasta(const char *buf, long n,
                    unsigned char *codes, long *code_off,
                    char *id_heap, long *id_off,
                    char *def_heap, long *def_off) {
    // 6-bit code table per io/alphabet.py
    static unsigned char code_tab[256];
    static bool keep_data[256];
    static bool is_alpha_tab[256];
    static bool init_done = false;
    if (!init_done) {
        for (int i = 0; i < 256; i++) { code_tab[i] = 63; keep_data[i] = false; is_alpha_tab[i] = false; }
        for (int c = 'A'; c <= 'Z'; c++) { code_tab[c] = (unsigned char)(c - 'A'); keep_data[c] = true; is_alpha_tab[c] = true; }
        for (int c = 'a'; c <= 'z'; c++) { code_tab[c] = (unsigned char)(c - 'a' + 26); keep_data[c] = true; is_alpha_tab[c] = true; }
        code_tab[(int)'*'] = 52; keep_data[(int)'*'] = true;
        init_done = true;
    }

    long nseq = 0;
    long ncodes = 0, nid = 0, ndef = 0;
    code_off[0] = 0; id_off[0] = 0; def_off[0] = 0;

    long i = 0;
    bool in_seq = false;
    bool first_data_line = false;
    while (i < n) {
        // find end of line
        long j = i;
        while (j < n && buf[j] != '\n') j++;
        long len = j - i;
        long header_at = -1;  // position AFTER a '>' that opens a record
        if (!in_seq) {
            // s_start: every char before the first '>' is error-dropped,
            // so '>' opens a record anywhere in the line
            // (fasta_parser.h:53-62)
            for (long p = i; p < j; p++)
                if (buf[p] == '>') { header_at = p + 1; break; }
            if (header_at < 0) { i = j + 1; continue; }
        } else if (!first_data_line) {
            // s_id_or_data: leading non-letters are dropped one by one;
            // a '>' in that run ends the record (fasta_parser.h:109-133)
            long p = i;
            while (p < j && !is_alpha_tab[(unsigned char)buf[p]]) {
                if (buf[p] == '>') { header_at = p + 1; break; }
                p++;
            }
            if (header_at < 0) {
                for (; p < j; p++) {
                    unsigned char c = (unsigned char)buf[p];
                    if (keep_data[c]) codes[ncodes++] = code_tab[c];
                }
                i = j + 1;
                continue;
            }
            // emit the finished record below, then parse the header
            nseq++;
            code_off[nseq] = ncodes;
            id_off[nseq] = nid;
            def_off[nseq] = ndef;
            in_seq = false;
        } else {
            // s_data (first line after a header): every char including
            // '>' is independently kept or error-dropped
            // (fasta_parser.h:91-107)
            for (long p = i; p < j; p++) {
                unsigned char c = (unsigned char)buf[p];
                if (keep_data[c]) codes[ncodes++] = code_tab[c];
            }
            // the '\n' ending this (possibly empty) line moves the DFA
            // from s_data to s_id_or_data
            (void)len;
            first_data_line = false;
            i = j + 1;
            continue;
        }
        // parse header starting at header_at ('\r' is skipped everywhere,
        // fasta_parser.h:47-48; a blank ends the id and begins the defline)
        in_seq = true;
        first_data_line = true;
        long p = header_at;
        while (p < j) {
            char c = buf[p];
            if (c == '\r') { p++; continue; }
            if (c == ' ' || c == '\t') break;
            id_heap[nid++] = c;
            p++;
        }
        while (p < j) {
            if (buf[p] != '\r') def_heap[ndef++] = buf[p];
            p++;
        }
        i = j + 1;
    }
    // parse_complete() emits UNCONDITIONALLY (fasta_parser.cc:29-36):
    // record-less input still yields one final all-empty record
    // (consumers drop empty-id records, as every reference callback does)
    nseq++;
    code_off[nseq] = ncodes;
    id_off[nseq] = nid;
    def_off[nseq] = ndef;
    (void)in_seq;
    return nseq;
}

// ---------------------------------------------------------------------------
// Hit automaton
// ---------------------------------------------------------------------------

static double median_of(std::vector<double> &v) {
    // boost::math::statistics::median semantics: even n averages the two
    // middle elements (ref: call_functions.tcc:52)
    std::sort(v.begin(), v.end());
    size_t m = v.size();
    if (m == 0) return 0.0;
    if (m % 2) return v[m / 2];
    return (v[m / 2 - 1] + v[m / 2]) / 2.0;
}

struct Hit { int32_t pos; int32_t func; int32_t mean; };

// Runs the automaton for each sequence; emits calls contiguously.
// Output capacity must be >= total number of hits (one call per flush max).
// call_offsets has n_seqs+1 entries.  Returns total calls.
long skt_automaton(const int32_t *hit_pos, const int32_t *hit_func,
                   const int32_t *hit_mean,
                   const int64_t *hit_offsets, const int32_t *seq_lens,
                   long n_seqs,
                   int min_hits, int max_gap, int kmer_size,
                   double mad_floor, double len_window,
                   int32_t *call_start, int32_t *call_end,
                   int32_t *call_count, int32_t *call_func,
                   int32_t *call_median, float *call_mad,
                   int64_t *call_offsets) {
    long ncalls = 0;
    std::vector<Hit> hits;
    std::vector<double> lengths, devs;
    call_offsets[0] = 0;

    for (long s = 0; s < n_seqs; s++) {
        hits.clear();
        int32_t current_fI = -1;  // UndefinedFunction stand-in (no valid -1)
        double seqlen = (double)seq_lens[s];

        // HitSet::process (ref: call_functions.tcc:35-103)
        auto process = [&]() {
            int fI_count = 0;
            int32_t last_match_pos = 0;
            lengths.clear();
            for (const Hit &h : hits) {
                if (h.func == current_fI) {
                    fI_count++;
                    last_match_pos = h.pos;
                    lengths.push_back((double)h.mean);
                }
            }
            if (fI_count > 0) {
                double mean_length = 0.0;
                for (double x : lengths) mean_length += x;
                mean_length /= (double)lengths.size();
                devs = lengths;
                double median_length = median_of(devs);
                for (double &x : devs) x = std::fabs(x - median_length);
                double mad = median_of(devs);
                if (mad == 0.0) mad = mad_floor;
                double lo = mean_length - len_window * mad;
                double hi = mean_length + len_window * mad;
                if (fI_count >= min_hits && seqlen >= lo && seqlen <= hi) {
                    call_start[ncalls] = hits[0].pos;
                    call_end[ncalls] = last_match_pos + kmer_size - 1;
                    call_count[ncalls] = fI_count;
                    call_func[ncalls] = current_fI;
                    call_median[ncalls] = (int32_t)median_length;
                    call_mad[ncalls] = (float)mad;
                    ncalls++;
                }
            }
            // tail: keep the last two hits when they agree on a new
            // function (ref: call_functions.tcc:88-102; single-hit case is
            // UB in the reference — defined here as clear, see FIDELITY.md)
            size_t m = hits.size();
            if (m >= 2 && hits[m - 2].func != current_fI &&
                hits[m - 2].func == hits[m - 1].func) {
                current_fI = hits[m - 2].func;
                Hit a = hits[m - 2], b = hits[m - 1];
                hits.clear();
                hits.push_back(a);
                hits.push_back(b);
            } else {
                hits.clear();
            }
        };

        for (int64_t h = hit_offsets[s]; h < hit_offsets[s + 1]; h++) {
            Hit cur{hit_pos[h], hit_func[h], hit_mean[h]};
            if (!hits.empty() && hits.back().pos + max_gap < cur.pos) {
                if ((int)hits.size() >= min_hits) process();
                else hits.clear();
            }
            if (hits.empty()) current_fI = cur.func;
            hits.push_back(cur);
            if (hits.size() > 1 && current_fI != cur.func) {
                size_t m = hits.size();
                if (hits[m - 2].func == hits[m - 1].func) process();
            }
        }
        if ((int)hits.size() >= min_hits) process();
        call_offsets[s + 1] = ncalls;
    }
    return ncalls;
}

// ---------------------------------------------------------------------------
// Best-call scoring (margin path)
// ---------------------------------------------------------------------------
//
// Native find_best_call (ref: call_functions.tcc:347-659) for the common
// case.  Sequences whose merged calls contain any multi-part function
// (candidate fusions — the only way the fusion regex can match) are
// flagged for the exact Python path; everything else is scored here:
// collapse -> interior-bridge merge -> per-function totals -> ">= margin"
// scoring with the "F1 ?? F2" fallback (string order via precomputed
// lexicographic ranks).
//
// out_kind: 0 = called, 1 = no call, 2 = ambiguous pair (f1/f2 set),
//           3 = needs the Python fusion path.

long skt_best_call(const int32_t *call_fI, const int32_t *call_count,
                   const int64_t *call_off, long n_seqs,
                   const uint8_t *is_multipart, const int32_t *lex_rank,
                   int interior_thresh, int exterior_thresh,
                   double margin, double pair_margin,
                   int32_t *out_kind, int32_t *out_func, float *out_score,
                   float *out_offset, int32_t *out_f1, int32_t *out_f2) {
    std::vector<std::pair<int32_t, int32_t>> merged;  // (fI, count)
    std::vector<std::pair<int32_t, int64_t>> totals;  // (fI, count)
    for (long s = 0; s < n_seqs; s++) {
        int64_t b = call_off[s], e = call_off[s + 1];
        out_kind[s] = 1;
        out_func[s] = -1;
        out_score[s] = 0.0f;
        out_offset[s] = 0.0f;
        out_f1[s] = -1;
        out_f2[s] = -1;
        if (e == b) continue;

        // collapse adjacent same-function calls (tcc:368-389)
        merged.clear();
        std::vector<std::pair<int32_t, int32_t>> collapsed;
        for (int64_t i = b; i < e; i++) {
            if (!collapsed.empty() && collapsed.back().first == call_fI[i])
                collapsed.back().second += call_count[i];
            else
                collapsed.emplace_back(call_fI[i], call_count[i]);
        }
        // interior-bridge merge; interior count discarded (tcc:398-434)
        size_t i = 0;
        while (i < collapsed.size()) {
            merged.push_back(collapsed[i]);
            i++;
            while (i < collapsed.size() && i + 1 < collapsed.size()
                   && merged.back().first == collapsed[i + 1].first
                   && collapsed[i].second < interior_thresh
                   && merged.back().second + collapsed[i + 1].second
                      >= exterior_thresh) {
                merged.back().second += collapsed[i + 1].second;
                i += 2;
            }
        }
        if (merged.size() > 1) {
            bool fusiony = false;
            for (auto &mc : merged)
                if (is_multipart[mc.first]) { fusiony = true; break; }
            if (fusiony) { out_kind[s] = 3; continue; }
        }
        // per-function totals in std::map iteration order (ascending fI),
        // then the reference's EXACT top-2 partial_sort (tcc:594-597).
        // partial_sort only orders the first two entries — but the pair
        // fallback below reads totals[2], whose content is libstdc++'s
        // __heap_select displacement leftover, NOT the third-largest
        // total.  Using std::partial_sort here (same libstdc++ the
        // deployed reference links) reproduces that placement by
        // construction; cross-validated in tests/test_reference_scoring.py.
        totals.clear();
        for (auto &mc : merged) {
            bool found = false;
            for (auto &t : totals)
                if (t.first == mc.first) { t.second += mc.second; found = true; break; }
            if (!found) totals.emplace_back(mc.first, (int64_t)mc.second);
        }
        std::sort(totals.begin(), totals.end(),
                  [](const auto &a, const auto &b2) { return a.first < b2.first; });
        if (totals.size() > 1)
            std::partial_sort(totals.begin(), totals.begin() + 2, totals.end(),
                              [](const auto &a, const auto &b2) {
                                  return a.second > b2.second;
                              });
        double offset = totals.size() == 1
            ? (double)totals[0].second
            : (double)(totals[0].second - totals[1].second);
        out_offset[s] = (float)offset;
        if (offset >= margin) {
            out_kind[s] = 0;
            out_func[s] = totals[0].first;
            out_score[s] = (float)totals[0].second;
            continue;
        }
        if (totals.size() >= 2) {
            int32_t a = totals[0].first, b2 = totals[1].first;
            // f1 = lexicographically greater function string (tcc:636-639)
            int32_t f1 = (lex_rank[b2] > lex_rank[a]) ? b2 : a;
            int32_t f2 = (f1 == a) ? b2 : a;
            if (totals.size() == 2) {
                out_kind[s] = 2;
                out_f1[s] = f1;
                out_f2[s] = f2;
                out_score[s] = (float)totals[0].second;
            } else {
                double po = (double)(totals[1].second - totals[2].second);
                if (po > pair_margin) {
                    out_kind[s] = 2;
                    out_f1[s] = f1;
                    out_f2[s] = f2;
                    out_score[s] = (float)totals[0].second;
                    out_offset[s] = (float)po;
                }
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Single-thread CPU calling baseline
// ---------------------------------------------------------------------------
//
// A faithful CPU re-creation of the reference's inference hot path: one
// hash probe per residue position (ref: call_functions.tcc:276-335 does one
// cmph_search + mmap read per position) followed by the same sequential
// automaton.  Used by bench.py to measure an honest "reference-style CPU"
// sequences/s on this machine as the vs_baseline denominator.

static inline uint32_t fmix32(uint32_t x) {
    x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u; x ^= x >> 16;
    return x;
}
static inline uint32_t hash_kmer_u32(uint32_t hi, uint32_t lo) {
    return fmix32(hi ^ (fmix32(lo) + 0x9E3779B9u));
}

// codes: concatenated 6-bit residue codes; seq_off: n_seqs+1.
// packed: bucketed table rows (n_buckets x 12 uint32: khi*4, klo*4, fm*4)
// as produced by table/bucket_table.py.  Returns total emitted calls.
long skt_cpu_baseline(const unsigned char *codes, const int64_t *seq_off,
                      long n_seqs,
                      const uint32_t *packed, long n_buckets, uint32_t salt,
                      int slots_per_bucket,
                      int min_hits, int max_gap, int kmer_size,
                      double mad_floor, double len_window) {
    const int SL = slots_per_bucket;
    const uint32_t mask = (uint32_t)(n_buckets - 1);
    const int K = kmer_size;
    long total_calls = 0;
    std::vector<Hit> hits;
    std::vector<double> lengths, devs;

    for (long s = 0; s < n_seqs; s++) {
        int64_t b = seq_off[s], e = seq_off[s + 1];
        long len = (long)(e - b);
        double seqlen = (double)len;
        hits.clear();
        int32_t current_fI = -1;
        long n_calls_seq = 0;

        auto process = [&]() {
            int fI_count = 0;
            int32_t last_match_pos = 0;
            lengths.clear();
            for (const Hit &h : hits) {
                if (h.func == current_fI) {
                    fI_count++;
                    last_match_pos = h.pos;
                    lengths.push_back((double)h.mean);
                }
            }
            if (fI_count > 0) {
                double mean_length = 0.0;
                for (double x : lengths) mean_length += x;
                mean_length /= (double)lengths.size();
                devs = lengths;
                double med = median_of(devs);
                for (double &x : devs) x = std::fabs(x - med);
                double mad = median_of(devs);
                if (mad == 0.0) mad = mad_floor;
                if (fI_count >= min_hits &&
                    seqlen >= mean_length - len_window * mad &&
                    seqlen <= mean_length + len_window * mad) {
                    n_calls_seq++;
                    (void)last_match_pos;
                }
            }
            size_t m = hits.size();
            if (m >= 2 && hits[m - 2].func != current_fI &&
                hits[m - 2].func == hits[m - 1].func) {
                current_fI = hits[m - 2].func;
                Hit a2 = hits[m - 2], b2 = hits[m - 1];
                hits.clear();
                hits.push_back(a2);
                hits.push_back(b2);
            } else {
                hits.clear();
            }
        };

        // rolling window; skip windows containing '*' (52) or 'X' (23) —
        // K+1-wide exclusion: for_each_kmer's jump tests kend >=
        // next_ambig (kmer_data.h:88-90), so the window ENDING at an
        // ambiguous char is skipped too (final window exempt)
        for (long p = 0; p + K <= len; p++) {
            bool ok = true;
            uint32_t hi = 0, lo = 0;
            for (int j = 0; j < 4; j++) {
                unsigned char c = codes[b + p + j];
                if (c == 52 || c == 23) { ok = false; break; }
                hi = (hi << 6) | c;
            }
            if (ok) {
                for (int j = 4; j < 8; j++) {
                    unsigned char c = codes[b + p + j];
                    if (c == 52 || c == 23) { ok = false; break; }
                    lo = (lo << 6) | c;
                }
            }
            if (ok && p + K < len) {
                unsigned char c9 = codes[b + p + K];
                if (c9 == 52 || c9 == 23) ok = false;
            }
            if (!ok) continue;
            // two-choice bucketed probe (matches bucket_hashes in
            // table/bucket_table.py)
            uint32_t b1 = fmix32(hi ^ fmix32(lo ^ salt)) & mask;
            uint32_t b2 = fmix32(lo ^ fmix32(hi ^ (salt + 0x9E3779B9u))) & mask;
            uint32_t fm = 0;
            bool hitk = false;
            for (int bi = 0; bi < 2 && !hitk; bi++) {
                const uint32_t *row = packed + (size_t)(bi ? b2 : b1) * (3 * SL);
                for (int sl = 0; sl < SL; sl++) {
                    if (row[sl] == hi && row[SL + sl] == lo) {
                        fm = row[2 * SL + sl];
                        hitk = true;
                        break;
                    }
                }
            }
            if (hitk) {
                Hit cur{(int32_t)p, (int32_t)(fm >> 16),
                        (int32_t)(fm & 0xFFFFu)};
                if (!hits.empty() && hits.back().pos + max_gap < cur.pos) {
                    if ((int)hits.size() >= min_hits) process();
                    else hits.clear();
                }
                if (hits.empty()) current_fI = cur.func;
                hits.push_back(cur);
                if (hits.size() > 1 && current_fI != cur.func) {
                    size_t m = hits.size();
                    if (hits[m - 2].func == hits[m - 1].func) process();
                }
            }
        }
        if ((int)hits.size() >= min_hits) process();
        total_calls += n_calls_seq;
    }
    return total_calls;
}

// ---------------------------------------------------------------------------
// Authentic reference-read-path CPU baseline (CMPH BDZ)
// ---------------------------------------------------------------------------
//
// The production reference caller probes a CMPH BDZ minimal perfect hash
// and an unverified flat mmap'd value array: per residue position it does
// one Jenkins lookup2 hash (3 lanes), three mod-r reads of a packed 2-bit
// g-array, a rank (ranktable entry + byte scan over the rank block), and
// one 10-byte StoredKmerData read — with NO membership check, so alien
// windows alias onto arbitrary slots (ref: cmph_kmer.h:139-147, libcmph
// bdz.c bdz_search/rank, jenkins.c).  This function reproduces that exact
// memory-access pattern + the same sequential automaton, single thread.
// It is the honest vs_baseline denominator for bench.py; the faster
// skt_cpu_baseline above (exact-membership cuckoo probe) is kept and
// reported alongside.

// per-byte count of assigned (!= 3) 2-bit g-array fields, shared by the
// BDZ rank byte scans (baseline + search); magic-static init is
// thread-safe (both consumers run multi-threaded)
static const uint8_t *bdz_assigned_in_byte() {
    static const std::array<uint8_t, 256> tab = []() {
        std::array<uint8_t, 256> t{};
        for (int v = 0; v < 256; v++) {
            int cnt = 0;
            for (int f = 0; f < 4; f++)
                if (((v >> (2 * f)) & 3) != 3) cnt++;
            t[v] = (uint8_t)cnt;
        }
        return t;
    }();
    return tab.data();
}

static inline void jenkins_mix(uint32_t &a, uint32_t &b, uint32_t &c) {
    // canonical Bob Jenkins 1996 lookup2 mix (cmph jenkins.c)
    a -= b; a -= c; a ^= (c >> 13);
    b -= c; b -= a; b ^= (a << 8);
    c -= a; c -= b; c ^= (b >> 13);
    a -= b; a -= c; a ^= (c >> 12);
    b -= c; b -= a; b ^= (a << 16);
    c -= a; c -= b; c ^= (b >> 5);
    a -= b; a -= c; a ^= (c >> 3);
    b -= c; b -= a; b ^= (a << 10);
    c -= a; c -= b; c ^= (b >> 15);
}

// codes/seq_off as in skt_cpu_baseline; code_to_byte: 64-entry 6-bit-code
// -> raw residue character table (the reference hashes raw characters,
// cmph_kmer.h:91); g: packed 2-bit BDZ values (ceil(3r/4) bytes);
// ranktable as written by cmph_dump; values: m contiguous 10-byte
// StoredKmerData records.  Returns total emitted calls.
long skt_cpu_baseline_bdz(const unsigned char *codes, const int64_t *seq_off,
                          long n_seqs, const unsigned char *code_to_byte,
                          uint32_t seed, uint32_t r,
                          const unsigned char *g, const uint32_t *ranktable,
                          int rank_b, const unsigned char *values, long m,
                          int min_hits, int max_gap, int kmer_size,
                          double mad_floor, double len_window) {
    if (kmer_size != 8) return -1;  // jenkins path specialized to K=8 keys
    const uint8_t *assigned_in_byte = bdz_assigned_in_byte();
    long total_calls = 0;
    std::vector<Hit> hits;
    std::vector<double> lengths, devs;

    for (long s = 0; s < n_seqs; s++) {
        int64_t b0 = seq_off[s], e0 = seq_off[s + 1];
        long len = (long)(e0 - b0);
        double seqlen = (double)len;
        hits.clear();
        int32_t current_fI = -1;
        long n_calls_seq = 0;

        auto process = [&]() {
            // identical automaton flush to skt_cpu_baseline above
            int fI_count = 0;
            lengths.clear();
            for (const Hit &h : hits) {
                if (h.func == current_fI) {
                    fI_count++;
                    lengths.push_back((double)h.mean);
                }
            }
            if (fI_count > 0) {
                double mean_length = 0.0;
                for (double x : lengths) mean_length += x;
                mean_length /= (double)lengths.size();
                devs = lengths;
                double med = median_of(devs);
                for (double &x : devs) x = std::fabs(x - med);
                double mad = median_of(devs);
                if (mad == 0.0) mad = mad_floor;
                if (fI_count >= min_hits &&
                    seqlen >= mean_length - len_window * mad &&
                    seqlen <= mean_length + len_window * mad)
                    n_calls_seq++;
            }
            size_t hm = hits.size();
            if (hm >= 2 && hits[hm - 2].func != current_fI &&
                hits[hm - 2].func == hits[hm - 1].func) {
                current_fI = hits[hm - 2].func;
                Hit a2 = hits[hm - 2], b2 = hits[hm - 1];
                hits.clear();
                hits.push_back(a2);
                hits.push_back(b2);
            } else {
                hits.clear();
            }
        };

        for (long p = 0; p + 8 <= len; p++) {
            bool ok = true;
            unsigned char kb[8];
            for (int j = 0; j < 8; j++) {
                unsigned char c = codes[b0 + p + j];
                if (c == 52 || c == 23) { ok = false; break; }  // '*' / 'X'
                kb[j] = code_to_byte[c & 63];
            }
            if (ok && p + 8 < len) {
                // K+1-wide exclusion (kmer_data.h:88-90, kend >= next_ambig)
                unsigned char c9 = codes[b0 + p + 8];
                if (c9 == 52 || c9 == 23) ok = false;
            }
            if (!ok) continue;
            // __jenkins_hash_vector, keylen == 8
            uint32_t w0 = (uint32_t)kb[0] | ((uint32_t)kb[1] << 8)
                        | ((uint32_t)kb[2] << 16) | ((uint32_t)kb[3] << 24);
            uint32_t w1 = (uint32_t)kb[4] | ((uint32_t)kb[5] << 8)
                        | ((uint32_t)kb[6] << 16) | ((uint32_t)kb[7] << 24);
            uint32_t a = w0 + 0x9E3779B9u;
            uint32_t bb = w1 + 0x9E3779B9u;
            uint32_t c = seed + 8u;
            jenkins_mix(a, bb, c);
            // bdz_search: 3 vertices, 3 g reads, select, rank
            uint64_t hl[3] = {(uint64_t)(a % r),
                              (uint64_t)(bb % r) + r,
                              (uint64_t)(c % r) + 2ull * r};
            unsigned gv0 = (g[hl[0] >> 2] >> (((unsigned)hl[0] & 3) << 1)) & 3;
            unsigned gv1 = (g[hl[1] >> 2] >> (((unsigned)hl[1] & 3) << 1)) & 3;
            unsigned gv2 = (g[hl[2] >> 2] >> (((unsigned)hl[2] & 3) << 1)) & 3;
            uint64_t vertex = hl[(gv0 + gv1 + gv2) % 3];
            // bdz.c rank(): block entry + byte scan within the block
            uint64_t bidx = vertex >> rank_b;
            uint32_t rank = ranktable[bidx];
            uint64_t beg_v = bidx << rank_b;
            uint64_t beg_b = beg_v >> 2, end_b = vertex >> 2;
            while (beg_b < end_b) rank += assigned_in_byte[g[beg_b++]];
            beg_v = beg_b << 2;
            while (beg_v < vertex) {
                if (((g[beg_v >> 2] >> (((unsigned)beg_v & 3) << 1)) & 3) != 3)
                    rank++;
                beg_v++;
            }
            if (rank >= (uint32_t)m) continue;  // ref: kidx >= hash_size_
            // unverified flat record read — every valid window is a "hit"
            const unsigned char *rec = values + (size_t)rank * 10;
            Hit cur{(int32_t)p,
                    (int32_t)(rec[2] | ((uint32_t)rec[3] << 8)),
                    (int32_t)(rec[4] | ((uint32_t)rec[5] << 8))};
            if (!hits.empty() && hits.back().pos + max_gap < cur.pos) {
                if ((int)hits.size() >= min_hits) process();
                else hits.clear();
            }
            if (hits.empty()) current_fI = cur.func;
            hits.push_back(cur);
            if (hits.size() > 1 && current_fI != cur.func) {
                size_t hm = hits.size();
                if (hits[hm - 2].func == hits[hm - 1].func) process();
            }
        }
        if ((int)hits.size() >= min_hits) process();
        total_calls += n_calls_seq;
    }
    return total_calls;
}

// Multi-thread variant of the authentic baseline: sequences partitioned
// across threads, mirroring the reference's TBB parallel_for over parsed
// sequences (ref: kmers-call-functions.cc:91,167-189 with --n-threads;
// call_functions.tcc:184-208).  Per-sequence work is independent, so the
// partition is embarrassment-parallel; results are summed.
long skt_cpu_baseline_bdz_mt(const unsigned char *codes,
                             const int64_t *seq_off, long n_seqs,
                             const unsigned char *code_to_byte,
                             uint32_t seed, uint32_t r,
                             const unsigned char *g,
                             const uint32_t *ranktable, int rank_b,
                             const unsigned char *values, long m,
                             int min_hits, int max_gap, int kmer_size,
                             double mad_floor, double len_window,
                             int n_threads) {
    if (n_threads <= 1)
        return skt_cpu_baseline_bdz(codes, seq_off, n_seqs, code_to_byte,
                                    seed, r, g, ranktable, rank_b, values, m,
                                    min_hits, max_gap, kmer_size, mad_floor,
                                    len_window);
    if (n_threads > 64) n_threads = 64;
    std::vector<long> res((size_t)n_threads, 0);
    std::vector<std::thread> ths;
    long per = (n_seqs + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        long s0 = (long)t * per;
        long s1 = s0 + per < n_seqs ? s0 + per : n_seqs;
        if (s0 >= s1) break;
        ths.emplace_back([=, &res]() {
            res[t] = skt_cpu_baseline_bdz(
                codes, seq_off + s0, s1 - s0, code_to_byte, seed, r, g,
                ranktable, rank_b, values, m, min_hits, max_gap, kmer_size,
                mad_floor, len_window);
        });
    }
    for (auto &th : ths) th.join();
    long total = 0;
    for (long v : res) total += v;
    return total;
}

// ---------------------------------------------------------------------------
// Native BDZ minimal-perfect-hash construction (one seed attempt)
// ---------------------------------------------------------------------------
//
// The reference builds its production store with libcmph's BDZ algorithm
// (ref: perfect_hash.h:11-69, libcmph bdz.c): keys become edges of a
// 3-partite hypergraph, the graph is peeled, and a packed 2-bit g-array +
// ranktable are emitted.  interop/cmph.py specifies the exact round-based
// peel/assign this framework uses (all degree-1-incident edges removed per
// round; free vertex = FIRST degree-1 position; reverse-round assignment);
// this is the same algorithm with the numpy inner loops as native code —
// output bytes are IDENTICAL to the numpy path for any (keys, seed, r).
// ~20x faster at 20M keys (the numpy path leans on unbuffered ufunc.at).
//
// keys: m contiguous 8-byte keys.  g_packed: caller-allocated ceil(3r/4)
// bytes.  ranktable: caller-allocated ceil(3r/(1<<rank_b)) uint32.
// Returns 0 on success, -1 when the graph is not peelable with this seed
// (caller retries with the next seed, as bdz_new does).
int skt_bdz_build_try(const unsigned char *keys, long m, uint32_t seed,
                      uint32_t r, int rank_b, unsigned char *g_packed,
                      uint32_t *ranktable) {
    const uint64_t n = 3ull * r;
    std::vector<uint32_t> v0(m), v1(m), v2(m);
    // graph build is threaded: deg/xs updates are commutative
    // (add / xor), so relaxed atomics give the same final arrays as the
    // sequential loop regardless of interleaving
    std::unique_ptr<std::atomic<uint32_t>[]> deg_a(
        new std::atomic<uint32_t>[n]());
    std::unique_ptr<std::atomic<uint32_t>[]> xs_a(
        new std::atomic<uint32_t>[n]());
    {
        int nt = skt_threads();
        long per = (m + nt - 1) / nt;
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; t++) {
            long i0 = (long)t * per, i1 = i0 + per < m ? i0 + per : m;
            if (i0 >= i1) break;
            ths.emplace_back([&, i0, i1]() {
                for (long i = i0; i < i1; i++) {
                    const unsigned char *kb = keys + i * 8;
                    uint32_t w0 = (uint32_t)kb[0] | ((uint32_t)kb[1] << 8)
                                | ((uint32_t)kb[2] << 16)
                                | ((uint32_t)kb[3] << 24);
                    uint32_t w1 = (uint32_t)kb[4] | ((uint32_t)kb[5] << 8)
                                | ((uint32_t)kb[6] << 16)
                                | ((uint32_t)kb[7] << 24);
                    uint32_t a = w0 + 0x9E3779B9u, b = w1 + 0x9E3779B9u;
                    uint32_t c = seed + 8u;
                    jenkins_mix(a, b, c);
                    v0[i] = a % r;
                    v1[i] = b % r + r;
                    v2[i] = c % r + 2u * r;
                    uint32_t vv[3] = {v0[i], v1[i], v2[i]};
                    for (int p = 0; p < 3; p++) {
                        deg_a[vv[p]].fetch_add(1, std::memory_order_relaxed);
                        xs_a[vv[p]].fetch_xor((uint32_t)i,
                                              std::memory_order_relaxed);
                    }
                }
            });
        }
        for (auto &th : ths) th.join();
    }
    // the peel below is single-threaded; plain views are fine from here
    static_assert(sizeof(std::atomic<uint32_t>) == sizeof(uint32_t),
                  "atomic<u32> must be layout-compatible for the view");
    uint32_t *deg = reinterpret_cast<uint32_t *>(deg_a.get());
    uint32_t *xs = reinterpret_cast<uint32_t *>(xs_a.get());

    // round-based peel: per round, all vertices of degree 1 free the
    // edges they are incident to; the edge's recorded free position is
    // the FIRST degree-1 position (interop/cmph.py _peel)
    std::vector<uint32_t> order;      // peeled edge ids, round-major
    std::vector<uint8_t> freej;       // free position per peeled edge
    std::vector<long> round_off{0};   // round boundaries into order
    order.reserve(m); freej.reserve(m);
    std::vector<uint32_t> cand;       // deg-1 candidates for this round
    cand.reserve(1 << 16);
    for (uint64_t v = 0; v < n; v++)
        if (deg[v] == 1) cand.push_back((uint32_t)v);
    long alive = m;
    std::vector<uint32_t> eids, next_cand;
    while (alive > 0) {
        // d1 = candidates still at degree 1 now (vertex order);
        // eids = sorted unique incident edge ids
        eids.clear();
        for (uint32_t v : cand)
            if (deg[v] == 1) eids.push_back(xs[v]);
        if (eids.empty()) return -1;  // non-empty 2-core
        std::sort(eids.begin(), eids.end());
        eids.erase(std::unique(eids.begin(), eids.end()), eids.end());
        next_cand.clear();
        for (uint32_t e : eids) {
            uint32_t vv[3] = {v0[e], v1[e], v2[e]};
            int j = 0;
            for (; j < 3; j++)
                if (deg[vv[j]] == 1) break;
            order.push_back(e);
            freej.push_back((uint8_t)j);
        }
        // remove this round's edges after all js are decided (degrees
        // above describe round START, exactly like the vectorized spec)
        for (uint32_t e : eids) {
            uint32_t vv[3] = {v0[e], v1[e], v2[e]};
            for (int p = 0; p < 3; p++) {
                uint32_t u = vv[p];
                deg[u]--; xs[u] ^= e;
                if (deg[u] == 1) next_cand.push_back(u);
            }
        }
        alive -= (long)eids.size();
        round_off.push_back((long)order.size());
        std::swap(cand, next_cand);
        std::sort(cand.begin(), cand.end());
        cand.erase(std::unique(cand.begin(), cand.end()), cand.end());
    }

    // reverse-round assignment (interop/cmph.py _assign): within a round
    // edges are independent (a free vertex has degree 1 at round start,
    // so it appears in no other edge of the round)
    std::vector<uint8_t> gv(n, 3);  // UNASSIGNED
    for (long ri = (long)round_off.size() - 2; ri >= 0; ri--) {
        for (long q = round_off[ri]; q < round_off[ri + 1]; q++) {
            uint32_t e = order[q];
            uint32_t vv[3] = {v0[e], v1[e], v2[e]};
            int j = freej[q];
            int others = 0;
            for (int p = 0; p < 3; p++)
                if (p != j) others += gv[vv[p]];
            gv[vv[j]] = (uint8_t)(((j - others) % 3 + 3) % 3);
        }
    }

    // pack 2-bit g (little-endian within byte) + ranktable
    const uint64_t sizeg = (n + 3) / 4;
    memset(g_packed, 0, sizeg);
    for (uint64_t v = 0; v < n; v++)
        g_packed[v >> 2] |= (unsigned char)(gv[v] << ((v & 3) << 1));
    for (uint64_t v = n; v < sizeg * 4; v++)  // pad fields = UNASSIGNED
        g_packed[v >> 2] |= (unsigned char)(3u << ((v & 3) << 1));
    const uint64_t k = 1ull << rank_b;
    const uint64_t rts = (n + k - 1) / k;
    uint32_t acc = 0;
    for (uint64_t bidx = 0; bidx < rts; bidx++) {
        ranktable[bidx] = acc;
        uint64_t hi = std::min(n, (bidx + 1) * k);
        for (uint64_t v = bidx * k; v < hi; v++)
            if (gv[v] != 3) acc++;
    }
    return 0;
}

// Native bdz_search over n 8-byte keys (bdz.c bdz_search + rank):
// jenkins 3-lane hash, 3 g reads, representative select, ranktable entry
// + byte scan.  out_idx[i] in [0, m) for member keys; alien keys alias
// (the reference's own semantics, cmph_kmer.h:138-147).  Parallelized
// over keys (read-only tables).
void skt_bdz_search(const unsigned char *keys, long n, uint32_t seed,
                    uint32_t r, const unsigned char *g,
                    const uint32_t *ranktable, int rank_b,
                    uint32_t *out_idx) {
    const uint8_t *assigned_in_byte = bdz_assigned_in_byte();
    int nt = skt_threads();
    long per = (n + nt - 1) / nt;
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) {
        long i0 = (long)t * per, i1 = i0 + per < n ? i0 + per : n;
        if (i0 >= i1) break;
        ths.emplace_back([=]() {
            for (long i = i0; i < i1; i++) {
                const unsigned char *kb = keys + i * 8;
                uint32_t w0 = (uint32_t)kb[0] | ((uint32_t)kb[1] << 8)
                            | ((uint32_t)kb[2] << 16) | ((uint32_t)kb[3] << 24);
                uint32_t w1 = (uint32_t)kb[4] | ((uint32_t)kb[5] << 8)
                            | ((uint32_t)kb[6] << 16) | ((uint32_t)kb[7] << 24);
                uint32_t a = w0 + 0x9E3779B9u, b = w1 + 0x9E3779B9u;
                uint32_t c = seed + 8u;
                jenkins_mix(a, b, c);
                uint64_t hl[3] = {(uint64_t)(a % r),
                                  (uint64_t)(b % r) + r,
                                  (uint64_t)(c % r) + 2ull * r};
                unsigned g0 = (g[hl[0] >> 2] >> (((unsigned)hl[0] & 3) << 1)) & 3;
                unsigned g1 = (g[hl[1] >> 2] >> (((unsigned)hl[1] & 3) << 1)) & 3;
                unsigned g2 = (g[hl[2] >> 2] >> (((unsigned)hl[2] & 3) << 1)) & 3;
                uint64_t vertex = hl[(g0 + g1 + g2) % 3];
                uint64_t bidx = vertex >> rank_b;
                uint32_t rank = ranktable[bidx];
                uint64_t beg_v = bidx << rank_b;
                uint64_t beg_b = beg_v >> 2, end_b = vertex >> 2;
                while (beg_b < end_b) rank += assigned_in_byte[g[beg_b++]];
                beg_v = beg_b << 2;
                while (beg_v < vertex) {
                    if (((g[beg_v >> 2] >> (((unsigned)beg_v & 3) << 1)) & 3)
                        != 3)
                        rank++;
                    beg_v++;
                }
                out_idx[i] = rank;
            }
        });
    }
    for (auto &th : ths) th.join();
}

// For cross-checking the Python jenkins implementation (interop/hashes.py)
// against this independently written one: hashes 8-byte keys, writes a/b/c.
void skt_jenkins3_k8(const unsigned char *keys, long n, uint32_t seed,
                     uint32_t *out_a, uint32_t *out_b, uint32_t *out_c) {
    for (long i = 0; i < n; i++) {
        const unsigned char *kb = keys + i * 8;
        uint32_t w0 = (uint32_t)kb[0] | ((uint32_t)kb[1] << 8)
                    | ((uint32_t)kb[2] << 16) | ((uint32_t)kb[3] << 24);
        uint32_t w1 = (uint32_t)kb[4] | ((uint32_t)kb[5] << 8)
                    | ((uint32_t)kb[6] << 16) | ((uint32_t)kb[7] << 24);
        uint32_t a = w0 + 0x9E3779B9u, b = w1 + 0x9E3779B9u, c = seed + 8u;
        jenkins_mix(a, b, c);
        out_a[i] = a; out_b[i] = b; out_c[i] = c;
    }
}

// ---------------------------------------------------------------------------
// Native bucketed-cuckoo table build
//
// The reference builds its lookup structure natively too (CMPH BDZ,
// perfect_hash.h:11-69).  Classic cuckoo insertion with bounded kicks:
// try the 4 slots of bucket h1, then of h2, else evict a rotating victim
// and re-insert it.  ~seconds for 20M keys single-thread vs ~1 min for
// the vectorized-numpy fallback in table/bucket_table.py.
//
// khi/klo/fv0/fv1/fv2: n_buckets*4 output arrays (initialized here).
// Returns 0 on success, -1 when an insertion exceeds max_kicks (caller
// retries with a different salt / larger table).

long skt_build_cuckoo(const uint32_t *hi, const uint32_t *lo,
                      const uint32_t *v0, const uint32_t *v1,
                      const uint32_t *v2,
                      long n, long n_buckets, uint32_t salt, int max_kicks,
                      int slots_per_bucket,
                      uint32_t *khi, uint32_t *klo,
                      uint32_t *fv0, uint32_t *fv1, uint32_t *fv2) {
    const uint32_t mask = (uint32_t)(n_buckets - 1);
    const int SL = slots_per_bucket;
    const long slots = n_buckets * SL;
    for (long i = 0; i < slots; i++) {
        khi[i] = 0xFFFFFFFFu; klo[i] = 0xFFFFFFFFu;
        fv0[i] = 0; fv1[i] = 0; fv2[i] = 0;
    }
    // random-walk eviction: deterministic victim rotation can enter exact
    // cycles (observed at 2 slots/bucket even at load 0.5); a seeded
    // xorshift walk breaks them while keeping builds reproducible
    uint32_t rngs = salt | 1u;
    for (long i = 0; i < n; i++) {
        uint32_t chi = hi[i], clo = lo[i];
        uint32_t c0 = v0[i], c1 = v1[i], c2 = v2[i];
        int kicks = 0;
        for (;;) {
            uint32_t b1 = fmix32(chi ^ fmix32(clo ^ salt)) & mask;
            uint32_t b2 = fmix32(clo ^ fmix32(chi ^ (salt + 0x9E3779B9u))) & mask;
            long base1 = (long)b1 * SL, base2 = (long)b2 * SL;
            long placed = -1;
            for (int s = 0; s < SL; s++)
                if (khi[base1 + s] == 0xFFFFFFFFu) { placed = base1 + s; break; }
            if (placed < 0)
                for (int s = 0; s < SL; s++)
                    if (khi[base2 + s] == 0xFFFFFFFFu) { placed = base2 + s; break; }
            if (placed >= 0) {
                khi[placed] = chi; klo[placed] = clo;
                fv0[placed] = c0; fv1[placed] = c1; fv2[placed] = c2;
                break;
            }
            if (++kicks > max_kicks) return -1;
            rngs ^= rngs << 13; rngs ^= rngs >> 17; rngs ^= rngs << 5;
            uint32_t vb = (rngs & 1) ? b1 : b2;
            long vs = (long)vb * SL + (long)((rngs >> 1) % (uint32_t)SL);
            uint32_t thi = khi[vs], tlo = klo[vs];
            uint32_t t0 = fv0[vs], t1 = fv1[vs], t2 = fv2[vs];
            khi[vs] = chi; klo[vs] = clo;
            fv0[vs] = c0; fv1[vs] = c1; fv2[vs] = c2;
            chi = thi; clo = tlo; c0 = t0; c1 = t1; c2 = t2;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Native wide tagged-bucket placement (table/wide_table.py _place_tagged)
//
// One pass over the keys: 3-round Feistel permutation of the 48-bit key
// (exactly ops/hashing.perm48), split into (bucket, tag), first-come slot
// claim.  Identical output to the numpy fallback (stable bucket argsort
// there == input-order first-come here).  Writes straight into the final
// packed[n_buckets][2S] (tag*S, fm*S) and aux[n_buckets][3S] layouts.
// leftover gets input indices of keys whose bucket was already full, in
// input order.  Returns the leftover count, or -1 on a duplicate key
// (same bucket+tag == same key, since the permutation is injective).

// Parallel + prefetch-pipelined.  The loop is latency-bound: each key
// touches one random bucket row in a multi-GB region (main + aux + fill
// lines -> several TLB/cache misses at ~100 ns each).  Buckets/tags are
// precomputed so the placement loop can software-prefetch PF keys ahead,
// and threads own disjoint BUCKET ranges while all scanning the key
// stream in input order — per-bucket first-come order (and thus the
// output) is identical to the single-thread pass for any thread count.
long skt_build_wide(const uint32_t *hi, const uint32_t *lo,
                    const uint32_t *v0, const uint32_t *v1,
                    const uint32_t *v2,
                    long n, int bits, uint32_t salt, int S,
                    uint32_t *packed, uint32_t *aux, long *leftover) {
    const long nb = 1L << bits;
    const int T = skt_threads();
    const uint32_t M24 = 0xFFFFFFu;
    static const uint32_t RC[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};

    std::vector<uint32_t> bkt((size_t)n), tagv((size_t)n);
    std::vector<uint8_t> fill((size_t)nb, 0);
    std::atomic<bool> dup(false);
    std::vector<std::vector<long>> lo_parts((size_t)T);

    auto phase = [&](int t) {
        // init: disjoint bucket slices (streaming stores, ~GBs at scale)
        long b0 = nb * t / T, b1 = nb * (t + 1) / T;
        for (long b = b0; b < b1; b++) {
            uint32_t *row = packed + b * 2 * S;
            for (int s = 0; s < S; s++) row[s] = 0xFFFFFFFFu;
            for (int s = S; s < 2 * S; s++) row[s] = 0;
        }
        memset(aux + b0 * 3 * S, 0,
               (size_t)(b1 - b0) * 3 * S * sizeof(uint32_t));
        // bucket/tag precompute: disjoint key slices
        long i0 = n * t / T, i1 = n * (t + 1) / T;
        for (long i = i0; i < i1; i++) {
            uint32_t L = hi[i] & M24, R = lo[i] & M24;
            for (int r = 0; r < 3; r++) {
                uint32_t F = fmix32(R ^ (salt ^ RC[r])) & M24;
                uint32_t nL = R, nR = L ^ F;
                L = nL; R = nR;
            }
            if (bits <= 24) {
                bkt[i] = R & ((1u << bits) - 1u);
                tagv[i] = (L << (24 - bits)) | (R >> bits);
            } else {
                bkt[i] = ((L & ((1u << (bits - 24)) - 1u)) << 24) | R;
                tagv[i] = L >> (bits - 24);
            }
        }
    };
    auto place = [&](int t) {
        const uint32_t b0 = (uint32_t)(nb * t / T);
        const uint32_t b1 = (uint32_t)(nb * (t + 1) / T);
        std::vector<long> &lout = lo_parts[(size_t)t];
        const long PF = 24;  // prefetch distance (keys ahead)
        for (long i = 0; i < n; i++) {
            if (i + PF < n) {
                uint32_t pb = bkt[i + PF];
                if (pb >= b0 && pb < b1) {
                    __builtin_prefetch(packed + (long)pb * 2 * S, 1);
                    __builtin_prefetch(aux + (long)pb * 3 * S, 1);
                    __builtin_prefetch(fill.data() + pb, 1);
                }
            }
            uint32_t bucket = bkt[i];
            if (bucket < b0 || bucket >= b1) continue;
            uint32_t tag = tagv[i];
            uint32_t *row = packed + (long)bucket * 2 * S;
            int c = fill[bucket];
            for (int s = 0; s < c; s++)
                if (row[s] == tag) { dup.store(true); return; }
            if (c < S) {
                row[c] = tag;
                row[S + c] = ((v0[i] >> 16) << 16) | (v1[i] & 0xFFFFu);
                uint32_t *arow = aux + (long)bucket * 3 * S;
                arow[c] = v0[i]; arow[S + c] = v1[i]; arow[2 * S + c] = v2[i];
                fill[bucket] = (uint8_t)(c + 1);
            } else {
                lout.push_back(i);
            }
        }
    };

    if (T == 1) {
        phase(0);
        place(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; t++) ts.emplace_back(phase, t);
        for (auto &th : ts) th.join();
        ts.clear();
        for (int t = 0; t < T; t++) ts.emplace_back(place, t);
        for (auto &th : ts) th.join();
    }
    if (dup.load()) return -1;

    // merge per-thread leftovers back into global input order (each part
    // is already ascending)
    long nl = 0;
    std::vector<size_t> pos((size_t)T, 0);
    for (;;) {
        int best = -1;
        long bi = 0;
        for (int t = 0; t < T; t++)
            if (pos[(size_t)t] < lo_parts[(size_t)t].size()) {
                long v = lo_parts[(size_t)t][pos[(size_t)t]];
                if (best < 0 || v < bi) { best = t; bi = v; }
            }
        if (best < 0) break;
        leftover[nl++] = bi;
        pos[(size_t)best]++;
    }
    return nl;
}

// The entries of a wide tagged store (table/wide_table.py
// _occupied_tagged, the numpy spec): each occupied slot's 48-bit key from
// the Feistel inverse of its (bucket, tag) (ops/hashing.perm48_inv) and
// its three aux words, in bucket-major, slot order (np.nonzero's).
// key[i] = hi << 24 | lo; vals (n, 3) = the entries' (v0, v1, v2) rows.
// Threads own disjoint bucket ranges: a counting pass, then each writes
// its entries from its prefix.  Returns the entry count; writes nothing
// when it is above cap.
long skt_occupied_tagged(const uint32_t *packed, const uint32_t *aux,
                         long nb, int S, uint32_t salt, int bits, long cap,
                         int64_t *key, uint32_t *vals) {
    const int T = skt_threads();
    const uint32_t M24 = 0xFFFFFFu;
    static const uint32_t RC[3] = {0x9E3779B9u, 0x85EBCA6Bu, 0xC2B2AE35u};
    std::vector<long> count((size_t)T + 1, 0);
    auto run = [&](int t, bool fill) {
        const long b0 = nb * t / T, b1 = nb * (t + 1) / T;
        long at = fill ? count[(size_t)t] : 0, c = 0;
        for (long b = b0; b < b1; b++) {
            const uint32_t *row = packed + b * 2 * S;
            for (int s = 0; s < S; s++) {
                const uint32_t tag = row[s];
                if (tag == 0xFFFFFFFFu) continue;
                if (!fill) {
                    c++;
                    continue;
                }
                const uint32_t bucket = (uint32_t)b;
                uint32_t L, R;
                if (bits <= 24) {
                    L = tag >> (24 - bits);
                    R = ((tag & ((1u << (24 - bits)) - 1u)) << bits) | bucket;
                } else {
                    L = (tag << (bits - 24)) | (bucket >> 24);
                    R = bucket & M24;
                }
                for (int r = 2; r >= 0; r--) {
                    const uint32_t F = fmix32(L ^ (salt ^ RC[r])) & M24;
                    const uint32_t nL = R ^ F;
                    R = L;
                    L = nL;
                }
                const uint32_t *arow = aux + b * 3 * S;
                key[at] = ((int64_t)L << 24) | (int64_t)R;
                vals[3 * at] = arow[s];
                vals[3 * at + 1] = arow[S + s];
                vals[3 * at + 2] = arow[2 * S + s];
                at++;
            }
        }
        if (!fill) count[(size_t)t + 1] = c;
    };
    auto all = [&](bool fill) {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; t++) ts.emplace_back(run, t, fill);
        for (auto &th : ts) th.join();
    };
    all(false);
    for (int t = 0; t < T; t++) count[(size_t)t + 1] += count[(size_t)t];
    const long total = count[(size_t)T];
    if (total <= cap) all(true);
    return total;
}

// 16-code-aligned 6-bit row packing for the H2D code transfer (the
// device expands with ROW gathers; ops/kmer_pack.pack_u6_rows_host is
// the numpy spec this must match byte for byte).  packed is (R, 3)
// uint32; unused rows / tail lanes are all-INVALID (code 63 -> every
// bit set, so the fill is one memset).

static inline void pack16_u6(const unsigned char *c, uint32_t *w) {
    w[0] = ((uint32_t)c[0] << 26) | ((uint32_t)c[1] << 20)
         | ((uint32_t)c[2] << 14) | ((uint32_t)c[3] << 8)
         | ((uint32_t)c[4] << 2) | ((uint32_t)c[5] >> 4);
    w[1] = ((uint32_t)(c[5] & 15) << 28) | ((uint32_t)c[6] << 22)
         | ((uint32_t)c[7] << 16) | ((uint32_t)c[8] << 10)
         | ((uint32_t)c[9] << 4) | ((uint32_t)c[10] >> 2);
    w[2] = ((uint32_t)(c[10] & 3) << 30) | ((uint32_t)c[11] << 24)
         | ((uint32_t)c[12] << 18) | ((uint32_t)c[13] << 12)
         | ((uint32_t)c[14] << 6) | (uint32_t)c[15];
}

// final.kmers text dump: one "KKKKKKKK\tavg\tfn\t\n" row per entry, in
// input order (the caller pre-sorts).  decode[64] maps 6-bit residue
// codes to ASCII.  The Python per-row formatter costs ~7 us/row (~30 s
// for a 4.5M-signature build); this buffered writer is ~100x faster.
// Returns 0, or -1 on open/write failure.
long skt_write_final_kmers(const uint32_t *hi, const uint32_t *lo,
                           const uint16_t *avg, const uint16_t *fn,
                           long n, const char *decode, const char *path) {
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    const size_t CAP = 1u << 22;
    std::vector<char> buf;
    buf.reserve(CAP);
    char tmp[32];
    for (long i = 0; i < n; i++) {
        uint32_t h = hi[i], l = lo[i];
        const char row[9] = {
            decode[(h >> 18) & 63], decode[(h >> 12) & 63],
            decode[(h >> 6) & 63], decode[h & 63],
            decode[(l >> 18) & 63], decode[(l >> 12) & 63],
            decode[(l >> 6) & 63], decode[l & 63], '\t'};
        buf.insert(buf.end(), row, row + 9);
        int m = snprintf(tmp, sizeof tmp, "%u\t%u\t\n",
                         (unsigned)avg[i], (unsigned)fn[i]);
        buf.insert(buf.end(), tmp, tmp + m);
        if (buf.size() > CAP - 64) {
            if (fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
                fclose(f);
                return -1;
            }
            buf.clear();
        }
    }
    if (!buf.empty()
        && fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        fclose(f);
        return -1;
    }
    return fclose(f) ? -1 : 0;
}

// Parses final.kmers text in its writer's own layout: each line an
// 8-byte k-mer, a tab, 1-5 digits, a tab, 1-5 digits, a tab, a newline
// (values up to 65535).  code[256] maps bytes to 6-bit residue codes.
// Returns the rows parsed into hi/lo/avg/fn, or -1 at the first line in
// any other layout, or past cap rows (the caller then reads the file
// line by line).
long skt_parse_final_kmers(const unsigned char *buf, long n,
                           const unsigned char *code, long cap,
                           uint32_t *hi, uint32_t *lo, uint16_t *avg,
                           uint16_t *fn) {
    long row = 0, i = 0;
    while (i < n) {
        if (row >= cap || n - i < 9) return -1;
        uint32_t w[2] = {0, 0};
        for (int j = 0; j < 8; j++) {
            unsigned char c = buf[i + j];
            if (c == '\t' || c == '\n' || c == '\r') return -1;
            w[j >> 2] = (w[j >> 2] << 6) | code[c];
        }
        i += 8;
        if (buf[i++] != '\t') return -1;
        uint32_t f[2];
        for (int k = 0; k < 2; k++) {
            uint32_t v = 0;
            int digits = 0;
            while (i < n && buf[i] >= '0' && buf[i] <= '9') {
                if (++digits > 5) return -1;
                v = v * 10 + (uint32_t)(buf[i++] - '0');
            }
            if (!digits || v > 0xFFFF || i >= n || buf[i++] != '\t')
                return -1;
            f[k] = v;
        }
        if (i >= n || buf[i++] != '\n') return -1;
        hi[row] = w[0];
        lo[row] = w[1];
        avg[row] = (uint16_t)f[0];
        fn[row] = (uint16_t)f[1];
        row++;
    }
    return row;
}

void skt_pack_u6_rows(const unsigned char *codes, const int64_t *offsets,
                      const int32_t *lens, const int64_t *row_start,
                      long B, long R, uint32_t *packed) {
    memset(packed, 0xFF, (size_t)R * 3 * sizeof(uint32_t));
    for (long b = 0; b < B; b++) {
        const unsigned char *src = codes + offsets[b];
        long n = lens[b];
        uint32_t *w = packed + row_start[b] * 3;
        long full = n / 16;
        for (long r = 0; r < full; r++, src += 16, w += 3)
            pack16_u6(src, w);
        long rem = n - full * 16;
        if (rem) {
            unsigned char tmp[16];
            memset(tmp, 63, 16);
            memcpy(tmp, src, (size_t)rem);
            pack16_u6(tmp, w);
        }
    }
}

}  // extern "C"
