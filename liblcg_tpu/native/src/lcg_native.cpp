// Native host runtime for liblcg_tpu: the inherently-sequential passes that
// feed the device compute path.
//
// The reference runs its incomplete factorizations on the host too (native
// COO IC preconditioner.cpp:42-307; even the CUDA backend factorizes on host,
// preconditioner_cuda.cu:40-278).  Here they are C++ because a per-row
// sparse elimination has a strict sequential dependency chain — the one
// thing that must NOT go through XLA — and the pure-Python fallback is two
// orders of magnitude slower at 10^6-row scale.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image):
//   ic0_factorize_f64 / _c128   — IC(0)/ICT, returns L in COO (row-major)
//   ilu0_factorize_f64 / _c128  — ILU(0)/ILUT, unit-diag L and U in COO
//   level_schedule_i64          — dependency levels for triangular solves
//
// Inputs are CSR-ish: COO triplets sorted by (row, col) with duplicates
// pre-summed (the Python side normalizes).  Complex values travel as
// interleaved double pairs (numpy complex128 memory layout).
//
// All functions return 0 on success, -(row+1) on a breakdown at `row`
// (non-positive IC pivot / zero ILU pivot), matching the failure the
// Python implementation raises.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

template <typename T>
static double mag(const T &v) { return std::abs(v); }

// Sparse row workspace: dense value array + touched-index list.
template <typename T>
struct RowWorkspace {
    std::vector<T> val;
    std::vector<uint8_t> used;
    std::vector<int64_t> touched;
    explicit RowWorkspace(int64_t n) : val(n, T(0)), used(n, 0) {}
    void add(int64_t j, T v) {
        if (!used[j]) { used[j] = 1; touched.push_back(j); val[j] = v; }
        else val[j] += v;
    }
    void clear() {
        for (int64_t j : touched) { used[j] = 0; val[j] = T(0); }
        touched.clear();
    }
};

// Keep only the `fill` largest-magnitude entries of `keys` (by |val|).
template <typename T>
static void drop_smallest(std::vector<int64_t> &keys, const std::vector<T> &val,
                          int64_t fill) {
    if ((int64_t)keys.size() <= fill) return;
    std::nth_element(
        keys.begin(), keys.begin() + fill, keys.end(),
        [&](int64_t a, int64_t b) { return mag(val[a]) > mag(val[b]); });
    keys.resize(fill);
}

template <typename T>
static T sqrt_pivot(const T &v);
template <> double sqrt_pivot<double>(const double &v) { return std::sqrt(v); }
template <> std::complex<double> sqrt_pivot<std::complex<double>>(
    const std::complex<double> &v) { return std::sqrt(v); }

// Incomplete Cholesky A ~= L L^T (unconjugated-symmetric for complex,
// matching clcg_Cholesky, preconditioner_eigen.cpp:96-151).
// Input: lower-triangle COO of A sorted by (row, col), duplicates summed.
// Output: L in row-major COO including the diagonal.
template <typename T>
static int64_t ic_factorize(
    int64_t n, int64_t nnz,
    const int64_t *rows, const int64_t *cols, const T *vals,
    int64_t fill,
    int64_t *out_rows, int64_t *out_cols, T *out_vals,
    int64_t *out_nnz, int64_t cap) {
    // Row starts in the sorted triplets.
    std::vector<int64_t> starts(n + 1, 0);
    for (int64_t k = 0; k < nnz; ++k) starts[rows[k] + 1]++;
    for (int64_t i = 0; i < n; ++i) starts[i + 1] += starts[i];

    std::vector<T> diag(n, T(0));
    // Column-linked structure of finished L rows: for each column p, the
    // (row j, L[j][p]) pairs, appended as rows complete.
    std::vector<std::vector<std::pair<int64_t, T>>> cols_of(n);

    RowWorkspace<T> w(n);
    std::vector<int64_t> keys;
    int64_t out = 0;
    const bool allow_fill = fill > 0;

    for (int64_t i = 0; i < n; ++i) {
        w.clear();
        T a_ii = T(0);
        for (int64_t k = starts[i]; k < starts[i + 1]; ++k) {
            int64_t j = cols[k];
            if (j == i) a_ii += vals[k];
            else w.add(j, vals[k]);
        }
        // Eliminate in ascending column order; fill-in may extend the list.
        std::sort(w.touched.begin(), w.touched.end());
        for (size_t t = 0; t < w.touched.size(); ++t) {
            int64_t p = w.touched[t];
            T wp = w.val[p] / diag[p];
            w.val[p] = wp;
            if (wp == T(0)) continue;
            for (const auto &jl : cols_of[p]) {
                int64_t j = jl.first;
                if (j >= i) continue;
                if (w.used[j]) {
                    w.val[j] -= wp * jl.second;
                } else if (allow_fill) {
                    w.add(j, -wp * jl.second);
                    // keep touched sorted: insert into remaining range
                    auto it = std::lower_bound(
                        w.touched.begin() + t + 1, w.touched.end(), j);
                    std::rotate(it, w.touched.end() - 1, w.touched.end());
                }
            }
        }

        keys = w.touched;
        if (allow_fill) drop_smallest(keys, w.val, fill);

        T sq = a_ii;
        for (int64_t j : keys) sq -= w.val[j] * w.val[j];
        if constexpr (std::is_same_v<T, double>) {
            if (sq <= 0.0) return -(i + 1);
        }
        T d = sqrt_pivot<T>(sq);
        diag[i] = d;

        std::sort(keys.begin(), keys.end());
        if (out + (int64_t)keys.size() + 1 > cap) return -(n + 1);  // overflow
        for (int64_t j : keys) {
            out_rows[out] = i; out_cols[out] = j; out_vals[out] = w.val[j]; ++out;
            cols_of[j].push_back({i, w.val[j]});
        }
        out_rows[out] = i; out_cols[out] = i; out_vals[out] = d; ++out;
    }
    *out_nnz = out;
    return 0;
}

// Incomplete LU, IKJ variant with unit lower diagonal (Saad; reference
// Eigen lcg_incomplete_LU, preconditioner_eigen.cpp:600-744).
// Input: full COO of A sorted by (row, col), duplicates summed.
// Outputs: strictly-lower L (unit diag implied, appended by caller) and
// U including the diagonal.
template <typename T>
static int64_t ilu_factorize(
    int64_t n, int64_t nnz,
    const int64_t *rows, const int64_t *cols, const T *vals,
    int64_t fill,
    int64_t *l_rows, int64_t *l_cols, T *l_vals, int64_t *l_nnz, int64_t l_cap,
    int64_t *u_rows, int64_t *u_cols, T *u_vals, int64_t *u_nnz, int64_t u_cap) {
    std::vector<int64_t> starts(n + 1, 0);
    for (int64_t k = 0; k < nnz; ++k) starts[rows[k] + 1]++;
    for (int64_t i = 0; i < n; ++i) starts[i + 1] += starts[i];

    // Finished U rows (strictly upper part + diag), CSR-ish growing store.
    std::vector<int64_t> u_start{0};
    std::vector<int64_t> u_col_store;
    std::vector<T> u_val_store;
    std::vector<T> u_diag(n, T(0));

    RowWorkspace<T> w(n);
    const bool allow_fill = fill > 0;
    int64_t lo = 0, uo = 0;
    std::vector<int64_t> lkeys, ukeys;

    for (int64_t i = 0; i < n; ++i) {
        w.clear();
        for (int64_t k = starts[i]; k < starts[i + 1]; ++k)
            w.add(cols[k], vals[k]);

        std::sort(w.touched.begin(), w.touched.end());
        for (size_t t = 0; t < w.touched.size(); ++t) {
            int64_t k = w.touched[t];
            if (k >= i) break;
            T wk = w.val[k] / u_diag[k];
            w.val[k] = wk;
            if (wk == T(0)) continue;
            for (int64_t s = u_start[k]; s < u_start[k + 1]; ++s) {
                int64_t j = u_col_store[s];
                T ukj = u_val_store[s];
                if (w.used[j]) {
                    w.val[j] -= wk * ukj;
                } else if (allow_fill) {
                    w.add(j, -wk * ukj);
                    auto it = std::lower_bound(
                        w.touched.begin() + t + 1, w.touched.end(), j);
                    std::rotate(it, w.touched.end() - 1, w.touched.end());
                }
            }
        }

        lkeys.clear(); ukeys.clear();
        bool have_diag = false;
        for (int64_t j : w.touched) {
            if (j < i) lkeys.push_back(j);
            else if (j > i) ukeys.push_back(j);
            else have_diag = true;
        }
        if (!have_diag || w.val[i] == T(0)) return -(i + 1);
        u_diag[i] = w.val[i];

        if (allow_fill) {
            drop_smallest(lkeys, w.val, fill);
            drop_smallest(ukeys, w.val, fill);
            std::sort(lkeys.begin(), lkeys.end());
            std::sort(ukeys.begin(), ukeys.end());
        }

        if (lo + (int64_t)lkeys.size() > l_cap) return -(n + 1);
        if (uo + (int64_t)ukeys.size() + 1 > u_cap) return -(n + 1);
        for (int64_t j : lkeys) {
            l_rows[lo] = i; l_cols[lo] = j; l_vals[lo] = w.val[j]; ++lo;
        }
        u_rows[uo] = i; u_cols[uo] = i; u_vals[uo] = u_diag[i]; ++uo;
        for (int64_t j : ukeys) {
            u_rows[uo] = i; u_cols[uo] = j; u_vals[uo] = w.val[j]; ++uo;
            u_col_store.push_back(j);
            u_val_store.push_back(w.val[j]);
        }
        u_start.push_back((int64_t)u_col_store.size());
    }
    *l_nnz = lo;
    *u_nnz = uo;
    return 0;
}

}  // namespace

extern "C" {

int64_t ic0_factorize_f64(
    int64_t n, int64_t nnz, const int64_t *rows, const int64_t *cols,
    const double *vals, int64_t fill,
    int64_t *out_rows, int64_t *out_cols, double *out_vals,
    int64_t *out_nnz, int64_t cap) {
    return ic_factorize<double>(n, nnz, rows, cols, vals, fill,
                                out_rows, out_cols, out_vals, out_nnz, cap);
}

int64_t ic0_factorize_c128(
    int64_t n, int64_t nnz, const int64_t *rows, const int64_t *cols,
    const double *vals, int64_t fill,
    int64_t *out_rows, int64_t *out_cols, double *out_vals,
    int64_t *out_nnz, int64_t cap) {
    return ic_factorize<std::complex<double>>(
        n, nnz, rows, cols,
        reinterpret_cast<const std::complex<double> *>(vals), fill,
        out_rows, out_cols,
        reinterpret_cast<std::complex<double> *>(out_vals), out_nnz, cap);
}

int64_t ilu0_factorize_f64(
    int64_t n, int64_t nnz, const int64_t *rows, const int64_t *cols,
    const double *vals, int64_t fill,
    int64_t *l_rows, int64_t *l_cols, double *l_vals, int64_t *l_nnz, int64_t l_cap,
    int64_t *u_rows, int64_t *u_cols, double *u_vals, int64_t *u_nnz, int64_t u_cap) {
    return ilu_factorize<double>(n, nnz, rows, cols, vals, fill,
                                 l_rows, l_cols, l_vals, l_nnz, l_cap,
                                 u_rows, u_cols, u_vals, u_nnz, u_cap);
}

int64_t ilu0_factorize_c128(
    int64_t n, int64_t nnz, const int64_t *rows, const int64_t *cols,
    const double *vals, int64_t fill,
    int64_t *l_rows, int64_t *l_cols, double *l_vals, int64_t *l_nnz, int64_t l_cap,
    int64_t *u_rows, int64_t *u_cols, double *u_vals, int64_t *u_nnz, int64_t u_cap) {
    return ilu_factorize<std::complex<double>>(
        n, nnz, rows, cols,
        reinterpret_cast<const std::complex<double> *>(vals), fill,
        l_rows, l_cols, reinterpret_cast<std::complex<double> *>(l_vals),
        l_nnz, l_cap,
        u_rows, u_cols, reinterpret_cast<std::complex<double> *>(u_vals),
        u_nnz, u_cap);
}

// Dependency level per row of a triangular factor (for level-scheduled
// device solves): level[i] = 1 + max(level[j]) over off-diagonal deps j.
// `lower` nonzero -> process rows ascending, else descending.
// Off-diag triplets must be sorted by row (ascending).  Returns max level.
int64_t level_schedule_i64(
    int64_t n, int64_t nnz, const int64_t *rows, const int64_t *cols,
    int64_t lower, int64_t *level) {
    std::vector<int64_t> starts(n + 1, 0);
    for (int64_t k = 0; k < nnz; ++k) starts[rows[k] + 1]++;
    for (int64_t i = 0; i < n; ++i) starts[i + 1] += starts[i];
    std::memset(level, 0, sizeof(int64_t) * n);
    int64_t max_level = 0;
    if (lower) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t lv = 0;
            for (int64_t k = starts[i]; k < starts[i + 1]; ++k)
                lv = std::max(lv, level[cols[k]] + 1);
            level[i] = lv;
            max_level = std::max(max_level, lv);
        }
    } else {
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t lv = 0;
            for (int64_t k = starts[i]; k < starts[i + 1]; ++k)
                lv = std::max(lv, level[cols[k]] + 1);
            level[i] = lv;
            max_level = std::max(max_level, lv);
        }
    }
    return max_level;
}

}  // extern "C"
