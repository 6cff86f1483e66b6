// guidemaker_native: first-party native (C++) runtime for GuideMaker-TPU.
//
// The reference delegates all native compute to third-party C++ libraries
// (NMSLib HNSW, bedtools, onnxruntime, the `regex` C extension — see
// SURVEY.md §2). This library is the owned equivalent for the CPU side of
// the rebuilt framework:
//
//   * strict 2-bit genome encoding (the data-loader hot loop),
//   * overlapped degenerate-PAM scanning via IUPAC bit masks,
//   * exact Hamming k-NN with 2-bit packing + XOR/popcount and a bounded
//     insertion top-k (the CPU fallback / oracle for the device engines),
//   * banded Levenshtein distance (CPU fallback / oracle).
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11
// dependency). Threading uses std::thread; no global state.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Encoding
// ---------------------------------------------------------------------------

// Strict uppercase-only base codes: A=0 C=1 G=2 T=3, everything else 4.
void gm_encode(const char* seq, int64_t n, uint8_t* out) {
    static uint8_t table[256];
    static bool init = false;
    if (!init) {
        std::memset(table, 4, sizeof(table));
        table[(unsigned char)'A'] = 0;
        table[(unsigned char)'C'] = 1;
        table[(unsigned char)'G'] = 2;
        table[(unsigned char)'T'] = 3;
        init = true;
    }
    for (int64_t i = 0; i < n; ++i) out[i] = table[(unsigned char)seq[i]];
}

// ---------------------------------------------------------------------------
// Degenerate PAM scan (overlap-native)
// ---------------------------------------------------------------------------

// masks[j] is a 4-bit IUPAC membership mask for motif position j.
// Returns the number of match positions written to out (up to max_out).
int64_t gm_scan_pam(const uint8_t* codes, int64_t n, const uint8_t* masks,
                    int32_t p, int64_t* out, int64_t max_out) {
    static const uint8_t bit[5] = {1, 2, 4, 8, 0};
    int64_t cnt = 0;
    const int64_t limit = n - p + 1;
    for (int64_t i = 0; i < limit; ++i) {
        bool ok = true;
        for (int32_t j = 0; j < p; ++j) {
            if (!(bit[codes[i + j]] & masks[j])) { ok = false; break; }
        }
        if (ok) {
            if (cnt < max_out) out[cnt] = i;
            ++cnt;
        }
    }
    return cnt;
}

// ---------------------------------------------------------------------------
// Exact Hamming k-NN: 2-bit packing + XOR/popcount + insertion top-k
// ---------------------------------------------------------------------------

// Pack one guide (codes < 4, length L <= 32) into a single uint64,
// 2 bits per base.
static inline uint64_t pack2(const uint8_t* codes, int32_t L) {
    uint64_t v = 0;
    for (int32_t i = 0; i < L; ++i) v |= (uint64_t)(codes[i] & 3) << (2 * i);
    return v;
}

// Base mismatches between two packed guides: a base differs iff either of
// its two bits differs -> OR the xor with its own >>1, mask odd bits, popcount.
static inline int32_t ham2(uint64_t a, uint64_t b) {
    uint64_t x = a ^ b;
    x = (x | (x >> 1)) & 0x5555555555555555ULL;
    return (int32_t)__builtin_popcountll(x);
}

static void topk_range(const uint64_t* db, int64_t nd, const uint64_t* qs,
                       int64_t q_lo, int64_t q_hi, int32_t k,
                       int32_t* out_dist, int32_t* out_idx) {
    std::vector<int64_t> heap(k);  // packed (dist<<32)|idx keys, ascending
    for (int64_t q = q_lo; q < q_hi; ++q) {
        const uint64_t qv = qs[q];
        int32_t filled = 0;
        int64_t worst = INT64_MAX;
        for (int64_t j = 0; j < nd; ++j) {
            const int64_t key =
                ((int64_t)ham2(qv, db[j]) << 32) | (int64_t)j;
            if (filled < k) {
                // bounded insertion sort (k is small: <= 20)
                int32_t pos = filled++;
                while (pos > 0 && heap[pos - 1] > key) {
                    heap[pos] = heap[pos - 1];
                    --pos;
                }
                heap[pos] = key;
                worst = heap[filled - 1];
            } else if (key < worst) {
                int32_t pos = k - 1;
                while (pos > 0 && heap[pos - 1] > key) {
                    heap[pos] = heap[pos - 1];
                    --pos;
                }
                heap[pos] = key;
                worst = heap[k - 1];
            }
        }
        for (int32_t i = 0; i < k; ++i) {
            if (i < filled) {
                out_dist[q * k + i] = (int32_t)(heap[i] >> 32);
                out_idx[q * k + i] = (int32_t)(heap[i] & 0xffffffff);
            } else {
                out_dist[q * k + i] = -1;
                out_idx[q * k + i] = -1;
            }
        }
    }
}

// db_codes: (nd, L) uint8; q_codes: (nq, L) uint8; outputs (nq, k) int32.
void gm_hamming_topk(const uint8_t* db_codes, int64_t nd,
                     const uint8_t* q_codes, int64_t nq,
                     int32_t L, int32_t k, int32_t n_threads,
                     int32_t* out_dist, int32_t* out_idx) {
    std::vector<uint64_t> db(nd), qs(nq);
    for (int64_t i = 0; i < nd; ++i) db[i] = pack2(db_codes + i * L, L);
    for (int64_t i = 0; i < nq; ++i) qs[i] = pack2(q_codes + i * L, L);
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || nq < 2 * n_threads) {
        topk_range(db.data(), nd, qs.data(), 0, nq, k, out_dist, out_idx);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (nq + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, nq);
        if (lo >= hi) break;
        threads.emplace_back(topk_range, db.data(), nd, qs.data(), lo, hi, k,
                             out_dist, out_idx);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Levenshtein k-NN: bit-parallel Myers (1999) + insertion top-k
// ---------------------------------------------------------------------------

// Same algorithm as the JAX kernel `leven_block_myers` (knn/leven.py): the
// whole DP column for one (pattern, text) pair lives in one machine word,
// advanced one text character per step.  Guide length L <= 32 fits uint32.
// Top-k keys are packed (dist << 32) | idx, so ties break toward the lower
// db index — identical ordering to gm_hamming_topk and the JAX engines.
static void leven_topk_range(const uint8_t* db, int64_t nd, const uint8_t* qs,
                             int64_t q_lo, int64_t q_hi, int32_t L, int32_t k,
                             int32_t* out_dist, int32_t* out_idx) {
    const uint32_t mask =
        (L >= 32) ? 0xffffffffu : ((1u << L) - 1u);
    const uint32_t bit_m = 1u << (L - 1);
    std::vector<int64_t> heap(k);  // ascending insertion-sorted keys
    for (int64_t q = q_lo; q < q_hi; ++q) {
        const uint8_t* qc = qs + q * L;
        // per-query match bitmasks Peq[c]: bit i set iff pattern[i] == c
        uint32_t peq[4] = {0, 0, 0, 0};
        for (int32_t i = 0; i < L; ++i) peq[qc[i] & 3] |= 1u << i;
        int32_t filled = 0;
        int64_t worst = INT64_MAX;
        for (int64_t row = 0; row < nd; ++row) {
            const uint8_t* dc = db + row * L;
            uint32_t pv = mask, mv = 0;
            int32_t score = L;
            for (int32_t j = 0; j < L; ++j) {
                const uint32_t eq = peq[dc[j] & 3];
                const uint32_t xv = eq | mv;
                const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
                uint32_t ph = mv | (~(xh | pv) & mask);
                const uint32_t mh = pv & xh;
                if (ph & bit_m) ++score;
                else if (mh & bit_m) --score;
                ph = ((ph << 1) | 1u) & mask;
                pv = ((mh << 1) | (~(xv | ph) & mask)) & mask;
                mv = ph & xv;
            }
            const int64_t key = ((int64_t)score << 32) | (int64_t)row;
            if (filled < k) {
                int32_t pos = filled++;
                while (pos > 0 && heap[pos - 1] > key) {
                    heap[pos] = heap[pos - 1];
                    --pos;
                }
                heap[pos] = key;
                worst = heap[filled - 1];
            } else if (key < worst) {
                int32_t pos = k - 1;
                while (pos > 0 && heap[pos - 1] > key) {
                    heap[pos] = heap[pos - 1];
                    --pos;
                }
                heap[pos] = key;
                worst = heap[k - 1];
            }
        }
        for (int32_t i = 0; i < k; ++i) {
            if (i < filled) {
                out_dist[q * k + i] = (int32_t)(heap[i] >> 32);
                out_idx[q * k + i] = (int32_t)(heap[i] & 0xffffffff);
            } else {
                out_dist[q * k + i] = -1;
                out_idx[q * k + i] = -1;
            }
        }
    }
}

// db_codes: (nd, L) uint8; q_codes: (nq, L) uint8; outputs (nq, k) int32.
// Requires 1 <= L <= 32 (the Python wrapper gates longer guides to the
// JAX/full-DP paths).
void gm_leven_topk(const uint8_t* db_codes, int64_t nd,
                   const uint8_t* q_codes, int64_t nq,
                   int32_t L, int32_t k, int32_t n_threads,
                   int32_t* out_dist, int32_t* out_idx) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || nq < 2 * n_threads) {
        leven_topk_range(db_codes, nd, q_codes, 0, nq, L, k,
                         out_dist, out_idx);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t chunk = (nq + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, nq);
        if (lo >= hi) break;
        threads.emplace_back(leven_topk_range, db_codes, nd, q_codes, lo, hi,
                             L, k, out_dist, out_idx);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Levenshtein distance (full DP, equal-length inputs)
// ---------------------------------------------------------------------------

int32_t gm_levenshtein(const uint8_t* a, int32_t la, const uint8_t* b,
                       int32_t lb) {
    std::vector<int32_t> prev(lb + 1), cur(lb + 1);
    for (int32_t j = 0; j <= lb; ++j) prev[j] = j;
    for (int32_t i = 1; i <= la; ++i) {
        cur[0] = i;
        for (int32_t j = 1; j <= lb; ++j) {
            const int32_t sub = prev[j - 1] + (a[i - 1] != b[j - 1]);
            cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
        }
        std::swap(prev, cur);
    }
    return prev[lb];
}

}  // extern "C"
