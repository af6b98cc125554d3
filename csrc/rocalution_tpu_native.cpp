// Native setup-phase kernels for rocalution_tpu.
//
// Reference parity: the host backend's sequential factorization kernels —
// ILU(0) (host_matrix_csr.cpp ILU0Factorize), IC(0) (ICFactorize), ILUT
// (host_ilut_driver_csr.cpp) — and the MatrixMarket body parser
// (host_io.cpp read_matrix_mtx). These are inherently sequential row sweeps
// the reference also runs on the host CPU; here they are the C++ layer under
// the JAX/XLA compute path (built once, loaded via ctypes).
//
// C ABI throughout; all functions return 0 on success, negative row index-1
// on breakdown.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <set>
#include <utility>
#include <vector>

extern "C" {

// In-place IKJ ILU(0) on a CSR matrix with sorted column indices.
// After return, data holds L (strict lower, unit diagonal implied) and U
// (upper incl diagonal) in place.
int64_t rt_ilu0_csr(int64_t n, const int64_t* indptr, const int32_t* cols,
                double* data) {
    std::vector<int64_t> dp(n, -1);        // diagonal position per row
    std::vector<int64_t> pos(n, -1);       // column -> position map (scratch)
    for (int64_t i = 0; i < n; ++i) {
        const int64_t rs = indptr[i], re = indptr[i + 1];
        for (int64_t p = rs; p < re; ++p) {
            pos[cols[p]] = p;
            if (cols[p] == i) dp[i] = p;
        }
        if (dp[i] < 0) return -i - 1;  // no diagonal
        for (int64_t p = rs; p < re && cols[p] < i; ++p) {
            const int64_t k = cols[p];
            const double dk = data[dp[k]];
            if (dk == 0.0) return -k - 1;
            const double lik = data[p] / dk;
            data[p] = lik;
            for (int64_t q = dp[k] + 1; q < indptr[k + 1]; ++q) {
                const int64_t j = pos[cols[q]];
                if (j >= 0) data[j] -= lik * data[q];
            }
        }
        for (int64_t p = rs; p < re; ++p) pos[cols[p]] = -1;
    }
    return 0;
}

// In-place IC(0) on the LOWER triangle (cols <= row, sorted, diagonal last
// in each row). After return, data holds L with A ~= L L^T.
int64_t rt_ic0_csr(int64_t n, const int64_t* indptr, const int32_t* cols,
               double* data) {
    std::vector<int64_t> pos(n, -1);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t rs = indptr[i], re = indptr[i + 1];
        for (int64_t p = rs; p < re; ++p) pos[cols[p]] = p;
        for (int64_t p = rs; p < re - 1; ++p) {   // off-diagonals j < i
            const int64_t j = cols[p];
            const int64_t js = indptr[j], je = indptr[j + 1];
            double s = 0.0;
            for (int64_t q = js; q < je - 1; ++q) {   // row j cols < j
                const int64_t t = pos[cols[q]];
                if (t >= 0 && t < p) s += data[t] * data[q];
            }
            const double djj = data[je - 1];
            if (djj == 0.0) return -j - 1;
            data[p] = (data[p] - s) / djj;
        }
        double s = 0.0;
        for (int64_t p = rs; p < re - 1; ++p) s += data[p] * data[p];
        const double v = data[re - 1] - s;
        if (v <= 0.0) return -i - 1;
        data[re - 1] = std::sqrt(v);
        for (int64_t p = rs; p < re; ++p) pos[cols[p]] = -1;
    }
    return 0;
}

// ILUT(t, maxfill): threshold + max-fill incomplete LU.
// Outputs: per-row L (strict lower) and U (diag first, then upper) packed
// into caller-allocated arrays of capacity n*maxfill (L) and n*(maxfill+1)
// (U); l_count/u_count give entries per row.
int64_t rt_ilut_csr(int64_t n, const int64_t* indptr, const int32_t* cols,
                const double* data, double tol, int64_t maxfill,
                int32_t* l_cols, double* l_vals, int64_t* l_count,
                int32_t* u_cols, double* u_vals, int64_t* u_count) {
    std::vector<double> w(n, 0.0);
    std::vector<int64_t> occupied;      // sorted occupied columns
    occupied.reserve(256);
    // U rows stored as we go (diag first)
    std::vector<std::vector<int32_t>> Ucols(n);
    std::vector<std::vector<double>> Uvals(n);

    for (int64_t i = 0; i < n; ++i) {
        occupied.clear();
        const int64_t rs = indptr[i], re = indptr[i + 1];
        double row_norm = 0.0;
        for (int64_t p = rs; p < re; ++p) {
            w[cols[p]] = data[p];
            occupied.push_back(cols[p]);
            row_norm += data[p] * data[p];
        }
        std::sort(occupied.begin(), occupied.end());
        row_norm = std::sqrt(row_norm);
        const double drop = tol * (row_norm > 0 ? row_norm : 1.0);

        for (size_t oi = 0; oi < occupied.size(); ++oi) {
            const int64_t k = occupied[oi];
            if (k >= i) break;
            const double lik = w[k] / Uvals[k][0];
            if (std::fabs(lik) < drop) { w[k] = 0.0; continue; }
            w[k] = lik;
            const auto& uc = Ucols[k];
            const auto& uv = Uvals[k];
            for (size_t q = 1; q < uc.size(); ++q) {
                const int64_t c = uc[q];
                if (w[c] == 0.0) {
                    // new fill-in: keep `occupied` sorted
                    auto it = std::lower_bound(
                        occupied.begin(), occupied.end(), c);
                    if (it == occupied.end() || *it != c)
                        occupied.insert(it, c);
                    // re-fetch oi-invariant: insertion after position oi
                    // only (c > k >= occupied[oi]) so oi stays valid
                }
                w[c] -= lik * uv[q];
            }
        }
        if (w[i] == 0.0) return -i - 1;

        // split + threshold + keep largest `maxfill`
        std::vector<std::pair<double, int64_t>> lw, uw;
        for (int64_t c : occupied) {
            const double v = w[c];
            if (c < i) {
                if (std::fabs(v) >= drop && v != 0.0) lw.push_back({v, c});
            } else if (c > i) {
                if (std::fabs(v) >= drop) uw.push_back({v, c});
            }
            w[c] = (c == i) ? w[c] : w[c];
        }
        auto bymag = [](const std::pair<double, int64_t>& a,
                        const std::pair<double, int64_t>& b) {
            return std::fabs(a.first) > std::fabs(b.first);
        };
        if ((int64_t)lw.size() > maxfill) {
            std::nth_element(lw.begin(), lw.begin() + maxfill, lw.end(), bymag);
            lw.resize(maxfill);
        }
        if ((int64_t)uw.size() > maxfill) {
            std::nth_element(uw.begin(), uw.begin() + maxfill, uw.end(), bymag);
            uw.resize(maxfill);
        }
        auto bycol = [](const std::pair<double, int64_t>& a,
                        const std::pair<double, int64_t>& b) {
            return a.second < b.second;
        };
        std::sort(lw.begin(), lw.end(), bycol);
        std::sort(uw.begin(), uw.end(), bycol);

        int64_t lc = 0;
        for (auto& cv : lw) {
            l_cols[i * maxfill + lc] = (int32_t)cv.second;
            l_vals[i * maxfill + lc] = cv.first;
            ++lc;
        }
        l_count[i] = lc;
        Ucols[i].push_back((int32_t)i);
        Uvals[i].push_back(w[i]);
        for (auto& cv : uw) {
            Ucols[i].push_back((int32_t)cv.second);
            Uvals[i].push_back(cv.first);
        }
        int64_t uc2 = 0;
        for (size_t q = 0; q < Ucols[i].size(); ++q) {
            u_cols[i * (maxfill + 1) + uc2] = Ucols[i][q];
            u_vals[i * (maxfill + 1) + uc2] = Uvals[i][q];
            ++uc2;
        }
        u_count[i] = uc2;

        for (int64_t c : occupied) w[c] = 0.0;
        w[i] = 0.0;
    }
    return 0;
}

// Vanek greedy aggregation (reference: AMGGreedyAggregate,
// host_matrix_csr.cpp). Pass 1: nodes whose strong neighborhood is fully
// unaggregated seed an aggregate with it; pass 2: leftovers join an
// adjacent aggregate; pass 3: leftovers become singletons.
// agg must be pre-filled with -1. Returns the aggregate count.
int64_t rt_greedy_aggregate(int64_t n, const int64_t* indptr,
                            const int32_t* indices, int64_t* agg) {
    int64_t na = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        const int64_t rs = indptr[i], re = indptr[i + 1];
        if (re == rs) continue;
        bool all_free = true;
        for (int64_t p = rs; p < re; ++p)
            if (agg[indices[p]] != -1) { all_free = false; break; }
        if (all_free) {
            agg[i] = na;
            for (int64_t p = rs; p < re; ++p) agg[indices[p]] = na;
            ++na;
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            const int64_t a = agg[indices[p]];
            if (a != -1) { agg[i] = a; break; }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (agg[i] == -1) agg[i] = na++;
    return na;
}

// Classical Ruge-Stueben greedy C/F splitting (reference parity:
// RSCoarsening, host_matrix_csr.cpp:6782; algorithm per Stuben's classical
// two-pass coarsening). Inputs: S (strength CSR: row i strongly depends on
// its columns) and its transpose ST (columns strongly depending on i).
// cf must be pre-initialized: 0 = undecided, 2 = pre-forced F (isolated).
// On return cf[i] in {1 (C), 2 (F)}. second_pass != 0 additionally promotes
// one point of every strong F-F pair lacking a common C neighbor.
// Returns the number of C points.
int64_t rt_rs_coarsening(int64_t n, const int64_t* s_ptr,
                         const int32_t* s_idx, const int64_t* st_ptr,
                         const int32_t* st_idx, int second_pass,
                         int8_t* cf) {
    std::vector<int64_t> lambda(n, 0);
    std::set<std::pair<int64_t, int64_t>> q;   // (lambda, node), max at end
    for (int64_t i = 0; i < n; ++i) {
        if (cf[i] != 0) continue;
        lambda[i] = st_ptr[i + 1] - st_ptr[i];
        q.insert({lambda[i], i});
    }
    auto bump = [&](int64_t l, int64_t delta) {
        q.erase({lambda[l], l});
        lambda[l] += delta;
        q.insert({lambda[l], l});
    };
    while (!q.empty()) {
        const int64_t i = std::prev(q.end())->second;
        q.erase(std::prev(q.end()));
        cf[i] = 1;                               // C point
        // undecided points strongly depending on i become F
        for (int64_t p = st_ptr[i]; p < st_ptr[i + 1]; ++p) {
            const int64_t j = st_idx[p];
            if (cf[j] != 0) continue;
            q.erase({lambda[j], j});
            cf[j] = 2;
            // their dependencies become more attractive C candidates
            for (int64_t t = s_ptr[j]; t < s_ptr[j + 1]; ++t) {
                const int64_t l = s_idx[t];
                if (cf[l] == 0) bump(l, +1);
            }
        }
        // i's own dependencies lose one potential dependent
        for (int64_t p = s_ptr[i]; p < s_ptr[i + 1]; ++p) {
            const int64_t l = s_idx[p];
            if (cf[l] == 0) bump(l, -1);
        }
    }
    if (second_pass) {
        std::vector<int64_t> mark(n, -1);        // C neighbors of current i
        for (int64_t i = 0; i < n; ++i) {
            if (cf[i] != 2) continue;
            for (int64_t p = s_ptr[i]; p < s_ptr[i + 1]; ++p)
                if (cf[s_idx[p]] == 1) mark[s_idx[p]] = i;
            for (int64_t p = s_ptr[i]; p < s_ptr[i + 1]; ++p) {
                const int64_t j = s_idx[p];
                if (cf[j] != 2) continue;
                bool common = false;
                for (int64_t t = s_ptr[j]; t < s_ptr[j + 1]; ++t)
                    if (cf[s_idx[t]] == 1 && mark[s_idx[t]] == i) {
                        common = true;
                        break;
                    }
                if (!common) {
                    cf[j] = 1;                   // promote j to C
                    mark[j] = i;                 // j now a common C for i
                }
            }
        }
    }
    int64_t nc = 0;
    for (int64_t i = 0; i < n; ++i) nc += cf[i] == 1;
    return nc;
}

// One Notay pairwise-matching pass (reference: PairwiseAMG
// InitialPairwiseAggregation, host_matrix_csr.cpp): visit nodes in `order`;
// each unmatched node pairs with its strongest negative unmatched neighbor
// among couplings <= beta * (row's most negative off-diagonal), else stays
// a singleton. new_id must be pre-filled with -1. Returns the pair count.
int64_t rt_pairwise_match(int64_t m, const int64_t* indptr,
                          const int32_t* indices, const double* data,
                          double beta, const int64_t* order,
                          int64_t* new_id) {
    int64_t na = 0;
    for (int64_t oi = 0; oi < m; ++oi) {
        const int64_t i = order[oi];
        if (new_id[i] != -1) continue;
        const int64_t rs = indptr[i], re = indptr[i + 1];
        double neg_min = 0.0;
        for (int64_t p = rs; p < re; ++p)
            if (indices[p] != i && data[p] < neg_min) neg_min = data[p];
        int64_t best = -1;
        double best_v = 0.0;
        for (int64_t p = rs; p < re; ++p) {
            const int64_t j = indices[p];
            const double v = data[p];
            if (j != i && new_id[j] == -1 && v < 0.0 &&
                v <= beta * neg_min && v < best_v) {
                best = j;
                best_v = v;
            }
        }
        new_id[i] = na;
        if (best >= 0) new_id[best] = na;
        ++na;
    }
    return na;
}

// MatrixMarket coordinate body parser: reads `nnz` lines of
// "row col [val [imag]]" from an already-positioned offset in the file.
// ncols_per_line: 2 (pattern), 3 (real/integer), 4 (complex).
int rt_mtx_body(const char* path, int64_t header_offset, int64_t nnz,
                int ncols_per_line, int64_t* rows, int64_t* cols,
                double* re_vals, double* im_vals) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, (long)header_offset, SEEK_SET) != 0) {
        std::fclose(f);
        return -2;
    }
    for (int64_t k = 0; k < nnz; ++k) {
        long long r, c;
        double re = 1.0, im = 0.0;
        int got = 0;
        if (ncols_per_line == 2) {
            got = std::fscanf(f, "%lld %lld", &r, &c) == 2;
        } else if (ncols_per_line == 3) {
            got = std::fscanf(f, "%lld %lld %lf", &r, &c, &re) == 3;
        } else {
            got = std::fscanf(f, "%lld %lld %lf %lf", &r, &c, &re, &im) == 4;
        }
        if (!got) { std::fclose(f); return -3; }
        rows[k] = (int64_t)r - 1;
        cols[k] = (int64_t)c - 1;
        re_vals[k] = re;
        if (im_vals) im_vals[k] = im;
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Setup-phase sparse algebra: fused SA-Galerkin + generic SpGEMM.
//
// Reference parity: the device csrgemm / rsamg setup kernels
// (src/base/hip/hip_matrix_csr.cpp MatMatMult, hip_rsamg_csr.cpp) — the
// reference builds AMG levels entirely with accelerator kernels. Here the
// setup is host graph work (SURVEY §7: XLA cannot run dynamic-shape
// symbolic passes), so the analog is an optimized native layer: Gustavson
// row-merge with stamped accumulators, two worker threads, growable
// per-thread output buffers stitched once.
// ---------------------------------------------------------------------------

#include <thread>

namespace rt_internal {

struct HalfOut {
    std::vector<int32_t> col;
    std::vector<double> val;
};

// Gustavson rows [r0,r1) of C = A(n x k) @ B(k x m); cnt[i] = nnz of row i.
static void spgemm_rows(int64_t r0, int64_t r1, int64_t m,
                        const int64_t* ap, const int32_t* ac,
                        const double* av, const int64_t* bp,
                        const int32_t* bc, const double* bv,
                        int64_t* cnt, HalfOut* out) {
    std::vector<double> acc((size_t)m, 0.0);
    std::vector<int64_t> stamp((size_t)m, -1);
    std::vector<int32_t> touched;
    touched.reserve(512);
    for (int64_t i = r0; i < r1; ++i) {
        touched.clear();
        for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
            const int32_t j = ac[p];
            const double v = av[p];
            for (int64_t q = bp[j]; q < bp[j + 1]; ++q) {
                const int32_t c = bc[q];
                if (stamp[c] != i) {
                    stamp[c] = i;
                    acc[c] = v * bv[q];
                    touched.push_back(c);
                } else {
                    acc[c] += v * bv[q];
                }
            }
        }
        std::sort(touched.begin(), touched.end());
        cnt[i] = (int64_t)touched.size();
        for (int32_t c : touched) {
            out->col.push_back(c);
            out->val.push_back(acc[c]);
        }
    }
}

// Gustavson with an OPEN-ADDRESSING hash accumulator: for very wide
// outputs a dense stamp/value array (e.g. 268 MB at 16.7M columns) makes
// every accumulate a DRAM miss (the 16.7M-row Galerkin triple product is
// then dominated by accumulator misses). A few-KB
// per-row hash stays L1/L2-resident; rows here have O(100) distinct
// columns (Galerkin products of bounded-degree operators).
static void spgemm_rows_hash(int64_t r0, int64_t r1, int64_t m,
                             const int64_t* ap, const int32_t* ac,
                             const double* av, const int64_t* bp,
                             const int32_t* bc, const double* bv,
                             int64_t* cnt, HalfOut* out) {
    (void)m;
    int64_t cap = 1024;                     // power of two
    std::vector<int32_t> key((size_t)cap, -1);
    std::vector<double> val((size_t)cap, 0.0);
    std::vector<int64_t> touched;
    touched.reserve(1024);
    std::vector<std::pair<int32_t, double>> row;
    row.reserve(1024);
    for (int64_t i = r0; i < r1; ++i) {
        touched.clear();
        for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
            const int32_t j = ac[p];
            const double v = av[p];
            for (int64_t q = bp[j]; q < bp[j + 1]; ++q) {
                const int32_t c = bc[q];
                uint64_t h = ((uint64_t)(uint32_t)c * 2654435761u) &
                             (uint64_t)(cap - 1);
                while (true) {
                    if (key[h] == c) {
                        val[h] += v * bv[q];
                        break;
                    }
                    if (key[h] < 0) {
                        key[h] = c;
                        val[h] = v * bv[q];
                        touched.push_back((int64_t)h);
                        break;
                    }
                    h = (h + 1) & (uint64_t)(cap - 1);
                }
                if ((int64_t)touched.size() * 2 > cap) {
                    // grow + rehash (rare: rows are O(100) distinct cols)
                    std::vector<std::pair<int32_t, double>> save;
                    save.reserve(touched.size());
                    for (int64_t t : touched)
                        save.emplace_back(key[t], val[t]);
                    for (int64_t t : touched) key[t] = -1;
                    cap *= 4;
                    key.assign((size_t)cap, -1);
                    val.assign((size_t)cap, 0.0);
                    touched.clear();
                    for (auto& kv : save) {
                        uint64_t hh = ((uint64_t)(uint32_t)kv.first *
                                       2654435761u) & (uint64_t)(cap - 1);
                        while (key[hh] >= 0) hh = (hh + 1) &
                                                  (uint64_t)(cap - 1);
                        key[hh] = kv.first;
                        val[hh] = kv.second;
                        touched.push_back((int64_t)hh);
                    }
                }
            }
        }
        row.clear();
        for (int64_t t : touched) {
            row.emplace_back(key[t], val[t]);
            key[t] = -1;
        }
        std::sort(row.begin(), row.end());
        cnt[i] = (int64_t)row.size();
        for (auto& kv : row) {
            out->col.push_back(kv.first);
            out->val.push_back(kv.second);
        }
    }
}

// Stitch per-thread halves into one malloc'd CSR triplet.
static int64_t stitch(int64_t n, const std::vector<int64_t>& cnt,
                      const HalfOut* halves, int nh, int64_t** cp,
                      int32_t** cc, double** cv) {
    int64_t* ptr = (int64_t*)std::malloc((size_t)(n + 1) * sizeof(int64_t));
    ptr[0] = 0;
    for (int64_t i = 0; i < n; ++i) ptr[i + 1] = ptr[i] + cnt[i];
    const int64_t nnz = ptr[n];
    int32_t* col = (int32_t*)std::malloc((size_t)nnz * sizeof(int32_t));
    double* val = (double*)std::malloc((size_t)nnz * sizeof(double));
    int64_t off = 0;
    for (int h = 0; h < nh; ++h) {
        const int64_t sz = (int64_t)halves[h].col.size();
        if (sz) {
            std::memcpy(col + off, halves[h].col.data(),
                        (size_t)sz * sizeof(int32_t));
            std::memcpy(val + off, halves[h].val.data(),
                        (size_t)sz * sizeof(double));
        }
        off += sz;
    }
    *cp = ptr;
    *cc = col;
    *cv = val;
    return nnz;
}

static int64_t spgemm(int64_t n, int64_t m, const int64_t* ap,
                      const int32_t* ac, const double* av, const int64_t* bp,
                      const int32_t* bc, const double* bv, int64_t** cp,
                      int32_t** cc, double** cv) {
    std::vector<int64_t> cnt((size_t)n, 0);
    HalfOut halves[2];
    const int64_t mid = n / 2;
    // dense accumulators beyond ~4M output columns thrash DRAM (stamp +
    // value arrays no longer fit any cache) — switch to the per-row hash
    auto rows_fn = (m >= (int64_t)1 << 22) ? spgemm_rows_hash : spgemm_rows;
    if (n >= 4096) {
        std::thread t0(rows_fn, 0, mid, m, ap, ac, av, bp, bc, bv,
                       cnt.data(), &halves[0]);
        rows_fn(mid, n, m, ap, ac, av, bp, bc, bv, cnt.data(),
                &halves[1]);
        t0.join();
    } else {
        rows_fn(0, n, m, ap, ac, av, bp, bc, bv, cnt.data(), &halves[0]);
    }
    return stitch(n, cnt, halves, 2, cp, cc, cv);
}

// P rows [r0,r1) of the smoothed prolongation P = (I - w D^-1 A_f) T:
// strength filter + lumping + column relabel through agg with dedup.
static void sa_p_rows(int64_t r0, int64_t r1, const int64_t* ap,
                      const int32_t* ac, const double* av, const double* dval,
                      const double* dabs, const int64_t* agg, int64_t n_agg,
                      double eps2, double omega, int lump, int64_t* cnt,
                      HalfOut* out) {
    std::vector<double> acc((size_t)n_agg, 0.0);
    std::vector<int64_t> stamp((size_t)n_agg, -1);
    std::vector<int32_t> touched;
    touched.reserve(64);
    for (int64_t i = r0; i < r1; ++i) {
        touched.clear();
        double lump_i = 0.0;
        const double di_abs = dabs[i];
        for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
            const int32_t j = ac[p];
            if (j == i) continue;
            const double v = av[p];
            if (v * v < eps2 * di_abs * dabs[j]) lump_i += v;
        }
        const double afd = dval[i] + (lump ? lump_i : 0.0);
        const double invd = (afd != 0.0) ? 1.0 / afd : 1.0;
        auto push = [&](int64_t c, double x) {
            if (stamp[c] != i) {
                stamp[c] = i;
                acc[c] = x;
                touched.push_back((int32_t)c);
            } else {
                acc[c] += x;
            }
        };
        push(agg[i], 1.0 - omega * invd * afd);
        for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
            const int32_t j = ac[p];
            if (j == i) continue;
            const double v = av[p];
            if (v * v >= eps2 * di_abs * dabs[j]) {
                push(agg[j], -omega * invd * v);
            }
        }
        std::sort(touched.begin(), touched.end());
        int64_t kept = 0;
        for (int32_t c : touched) {
            if (acc[c] != 0.0) {  // eliminate exact zeros (scipy parity)
                out->col.push_back(c);
                out->val.push_back(acc[c]);
                ++kept;
            }
        }
        cnt[i] = kept;
    }
}

}  // namespace rt_internal

extern "C" {

void rt_free(void* p) { std::free(p); }

// C = A(n x k) @ B(k x m); outputs malloc'd (caller frees via rt_free).
// Returns nnz(C), or -1 on allocation failure.
int64_t rt_spgemm_csr(int64_t n, int64_t m, const int64_t* ap,
                      const int32_t* ac, const double* av, const int64_t* bp,
                      const int32_t* bc, const double* bv, int64_t** cp,
                      int32_t** cc, double** cv) {
    return rt_internal::spgemm(n, m, ap, ac, av, bp, bc, bv, cp, cc, cv);
}

// Fused smoothed-aggregation Galerkin build from the fine operator and an
// aggregate map: emits P = (I - w D^-1 A_f) T, R = P^T and Ac = R A P.
// out_nnz[0..2] = nnz(P), nnz(R), nnz(Ac). All outputs malloc'd.
int64_t rt_sa_galerkin(int64_t n, const int64_t* ap, const int32_t* ac,
                       const double* av, const int64_t* agg, int64_t n_agg,
                       double eps, double omega, int lump, int64_t** pp,
                       int32_t** pc, double** pv, int64_t** rp, int32_t** rc,
                       double** rv, int64_t** gp, int32_t** gc, double** gv,
                       int64_t* out_nnz) {
    using namespace rt_internal;
    // diagonal pass
    std::vector<double> dval((size_t)n, 0.0), dabs((size_t)n, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
            if (ac[p] == i) {
                dval[i] = av[p];
                dabs[i] = std::fabs(av[p]);
                break;
            }
        }
    }
    const double eps2 = eps * eps;
    // P (threaded)
    std::vector<int64_t> pcnt((size_t)n, 0);
    HalfOut ph[2];
    const int64_t mid = n / 2;
    if (n >= 4096) {
        std::thread t0(sa_p_rows, 0, mid, ap, ac, av, dval.data(),
                       dabs.data(), agg, n_agg, eps2, omega, lump,
                       pcnt.data(), &ph[0]);
        sa_p_rows(mid, n, ap, ac, av, dval.data(), dabs.data(), agg, n_agg,
                  eps2, omega, lump, pcnt.data(), &ph[1]);
        t0.join();
    } else {
        sa_p_rows(0, n, ap, ac, av, dval.data(), dabs.data(), agg, n_agg,
                  eps2, omega, lump, pcnt.data(), &ph[0]);
    }
    const int64_t pnnz = stitch(n, pcnt, ph, 2, pp, pc, pv);
    out_nnz[0] = pnnz;

    // R = P^T by counting sort (rows come out sorted by fine index)
    int64_t* rptr = (int64_t*)std::malloc((size_t)(n_agg + 1) * sizeof(int64_t));
    int32_t* rcol = (int32_t*)std::malloc((size_t)pnnz * sizeof(int32_t));
    double* rval = (double*)std::malloc((size_t)pnnz * sizeof(double));
    std::memset(rptr, 0, (size_t)(n_agg + 1) * sizeof(int64_t));
    const int64_t* pptr = *pp;
    const int32_t* pcol = *pc;
    const double* pval = *pv;
    for (int64_t e = 0; e < pnnz; ++e) rptr[pcol[e] + 1]++;
    for (int64_t c = 0; c < n_agg; ++c) rptr[c + 1] += rptr[c];
    std::vector<int64_t> wpos(rptr, rptr + n_agg);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = pptr[i]; p < pptr[i + 1]; ++p) {
            const int64_t d = wpos[pcol[p]]++;
            rcol[d] = (int32_t)i;
            rval[d] = pval[p];
        }
    }
    *rp = rptr;
    *rc = rcol;
    *rv = rval;
    out_nnz[1] = pnnz;

    // Ac = (R @ A) @ P
    int64_t *tp, *gp2;
    int32_t *tc, *gc2;
    double *tv, *gv2;
    spgemm(n_agg, n, rptr, rcol, rval, ap, ac, av, &tp, &tc, &tv);
    const int64_t gnnz =
        spgemm(n_agg, n_agg, tp, tc, tv, pptr, pcol, pval, &gp2, &gc2, &gv2);
    std::free(tp);
    std::free(tc);
    std::free(tv);
    *gp = gp2;
    *gc = gc2;
    *gv = gv2;
    out_nnz[2] = gnnz;
    return 0;
}

// Strength graph (pattern only): keep off-diagonal |a_ij|^2 >= eps^2 |a_ii a_jj|.
// Outputs malloc'd pattern CSR (cols only). Returns nnz.
int64_t rt_strength_graph(int64_t n, const int64_t* ap, const int32_t* ac,
                          const double* av, double eps, int64_t** sp_,
                          int32_t** sc_) {
    std::vector<double> dabs((size_t)n, 0.0);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
            if (ac[p] == i) {
                dabs[i] = std::fabs(av[p]);
                break;
            }
        }
    }
    const double eps2 = eps * eps;
    int64_t* sptr = (int64_t*)std::malloc((size_t)(n + 1) * sizeof(int64_t));
    sptr[0] = 0;
    auto strong_count = [&](int64_t r0, int64_t r1) {
        for (int64_t i = r0; i < r1; ++i) {
            int64_t cnt = 0;
            for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
                const int32_t j = ac[p];
                if (j != i && av[p] * av[p] >= eps2 * dabs[i] * dabs[j]) ++cnt;
            }
            sptr[i + 1] = cnt;
        }
    };
    {
        std::thread t0(strong_count, 0, n / 2);
        strong_count(n / 2, n);
        t0.join();
    }
    for (int64_t i = 0; i < n; ++i) sptr[i + 1] += sptr[i];
    const int64_t nnz = sptr[n];
    int32_t* scol = (int32_t*)std::malloc((size_t)nnz * sizeof(int32_t));
    auto strong_fill = [&](int64_t r0, int64_t r1) {
        for (int64_t i = r0; i < r1; ++i) {
            int64_t w = sptr[i];
            for (int64_t p = ap[i]; p < ap[i + 1]; ++p) {
                const int32_t j = ac[p];
                if (j != i && av[p] * av[p] >= eps2 * dabs[i] * dabs[j])
                    scol[w++] = j;
            }
        }
    };
    {
        std::thread t0(strong_fill, 0, n / 2);
        strong_fill(n / 2, n);
        t0.join();
    }
    *sp_ = sptr;
    *sc_ = scol;
    return nnz;
}

}  // extern "C"
