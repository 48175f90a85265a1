// Host maxvol and rectangular maxvol for the pivots of cross approximation.
//
// The host API of ``tntorch_tpu_torch/maxvol.py`` (the host cross sweep,
// ``cross(fuse="host")``, and the ``record_samples`` pivots of the
// minimizing cross) pivots NumPy matrices on the CPU. The swap loop is a
// sequential argmax and rank-1 update: NumPy makes several passes over C
// per swap (the argmax, the column and row copies, the outer product, the
// subtraction); this loop makes one. Built with the host C++ compiler by
// ``_build.py`` and loaded over ctypes by ``_native.py``.
//
// The order of operations and the tie-breaking are the JAX package's
// native library's, so that both give the same index sets bitwise:
//  - the argmax is two-level: the largest |C| of each row, kept up to date
//    during the rank-1 update, then the first row of the largest row
//    maximum, then the first column of that row's largest entry (the first
//    maximum in row-major order, as NumPy's argmax of |C| picks);
//  - a row whose coefficient in the pivot column is exactly 0 is skipped
//    by the update, its row maximum kept;
//  - a pivot of exactly 0 stops the loop;
//  - rect_maxvol fuses the update, the appended column, the row-norm
//    update and the next argmax into one pass.
// float32 matrices stay float32 (the ``*_f32`` entry points).
//
// Algorithms:
//   maxvol: Goreinov et al., "How to find a good submatrix" (2010)
//   rect_maxvol: Mikhalev & Oseledets, "Rectangular maximum-volume
//   submatrices and their applications" (2018)

#include <cmath>
#include <cstring>
#include <limits>
#include <utility>
#include <vector>

namespace {

// The r row pivots of a partially pivoted LU of tall A (n x r, row-major):
// the rows a square maxvol starts from.
template <typename T>
void lu_pivot_rows(const T* A, long n, long r, long* index) {
    std::vector<T> B(A, A + n * r);
    std::vector<long> perm(n);
    for (long i = 0; i < n; ++i) perm[i] = i;

    for (long k = 0; k < r; ++k) {
        long piv = k;
        T best = std::fabs(B[k * r + k]);
        for (long i = k + 1; i < n; ++i) {
            T v = std::fabs(B[i * r + k]);
            if (v > best) { best = v; piv = i; }
        }
        if (piv != k) {
            for (long j = 0; j < r; ++j) std::swap(B[k * r + j], B[piv * r + j]);
            std::swap(perm[k], perm[piv]);
        }
        T d = B[k * r + k];
        if (d == T(0)) d = std::numeric_limits<T>::min();
        for (long i = k + 1; i < n; ++i) {
            T l = B[i * r + k] / d;
            B[i * r + k] = l;
            for (long j = k + 1; j < r; ++j) B[i * r + j] -= l * B[k * r + j];
        }
    }
    for (long k = 0; k < r; ++k) index[k] = perm[k];
}

// C = A inv(S), S = A[rows] (r x r): an LU with partial pivoting of S^T,
// then for each row a of A the two triangular solves of x S = a. Returns 1
// when S is exactly singular.
template <typename T>
int coefficients(const T* A, long n, long r, const long* rows, T* C) {
    std::vector<T> Tm(r * r);
    for (long i = 0; i < r; ++i)
        for (long j = 0; j < r; ++j) Tm[i * r + j] = A[rows[j] * r + i];
    std::vector<long> piv(r);
    for (long k = 0; k < r; ++k) {
        long p = k;
        T best = std::fabs(Tm[k * r + k]);
        for (long i = k + 1; i < r; ++i) {
            T v = std::fabs(Tm[i * r + k]);
            if (v > best) { best = v; p = i; }
        }
        piv[k] = p;
        if (p != k)
            for (long j = 0; j < r; ++j) std::swap(Tm[k * r + j], Tm[p * r + j]);
        T d = Tm[k * r + k];
        if (d == T(0)) return 1;
        for (long i = k + 1; i < r; ++i) {
            T l = Tm[i * r + k] / d;
            Tm[i * r + k] = l;
            for (long j = k + 1; j < r; ++j) Tm[i * r + j] -= l * Tm[k * r + j];
        }
    }

    std::vector<T> y(r);
    for (long row = 0; row < n; ++row) {
        for (long j = 0; j < r; ++j) y[j] = A[row * r + j];
        for (long k = 0; k < r; ++k)
            if (piv[k] != k) std::swap(y[k], y[piv[k]]);
        for (long k = 0; k < r; ++k) {  // forward, unit lower triangle
            T acc = y[k];
            const T* Tk = &Tm[k * r];
            for (long i = 0; i < k; ++i) acc -= Tk[i] * y[i];
            y[k] = acc;
        }
        for (long k = r - 1; k >= 0; --k) {  // backward, upper triangle
            T acc = y[k];
            const T* Tk = &Tm[k * r];
            for (long i = k + 1; i < r; ++i) acc -= Tk[i] * y[i];
            y[k] = acc / Tk[k];
        }
        std::memcpy(&C[row * r], y.data(), r * sizeof(T));
    }
    return 0;
}

// The swap loop on C = A inv(A[idx]) (n x r, row-major), C and the r pivot
// rows idx updated in place: at most max_iters swaps, until max |C| <= tol.
template <typename T>
void maxvol_iterate(T* C, long n, long r, double tol_d, long max_iters, long* idx) {
    T tol = T(tol_d < 1.0 ? 1.0 : tol_d);

    // The largest |C| of each row: a reduction without indices, which
    // vectorizes; the argmax then scans n values
    std::vector<T> row_max(n);
    for (long i = 0; i < n; ++i) {
        T m = T(0);
        const T* Ci = &C[i * r];
        for (long j = 0; j < r; ++j) {
            T v = std::fabs(Ci[j]);
            m = v > m ? v : m;
        }
        row_max[i] = m;
    }

    std::vector<T> row(r);
    for (long it = 0; it < max_iters; ++it) {
        long bi = 0;
        T best = row_max[0];
        for (long i = 1; i < n; ++i)
            if (row_max[i] > best) { best = row_max[i]; bi = i; }
        if (best <= tol) break;
        long bj = 0;
        {
            const T* Cb = &C[bi * r];
            T bv = std::fabs(Cb[0]);
            for (long j = 1; j < r; ++j) {
                T v = std::fabs(Cb[j]);
                if (v > bv) { bv = v; bj = j; }
            }
        }
        // Row bi takes pivot slot bj; the rank-1 update of C rebuilds the
        // row maxima in the same pass
        idx[bj] = bi;
        T piv = C[bi * r + bj];
        if (piv == T(0)) break;  // no swap can make progress
        T inv = T(1) / piv;
        std::memcpy(row.data(), &C[bi * r], r * sizeof(T));
        row[bj] -= T(1);
        for (long i = 0; i < n; ++i) {
            T ci = C[i * r + bj] * inv;
            T* Ci = &C[i * r];
            T m = T(0);
            if (ci != T(0)) {
                for (long j = 0; j < r; ++j) {
                    T v = Ci[j] - ci * row[j];
                    Ci[j] = v;
                    v = std::fabs(v);
                    m = v > m ? v : m;
                }
                row_max[i] = m;
            }
        }
    }
}

// The whole maxvol in this file: the LU start, the coefficient solve and
// the swap loop. Returns 1 when the LU start's block is exactly singular.
template <typename T>
int maxvol_impl(const T* A, long n, long r, double tol_d, long max_iters, long* index,
                T* C) {
    if (n <= r) {
        for (long i = 0; i < n; ++i) index[i] = i;
        std::memset(C, 0, n * n * sizeof(T));
        for (long i = 0; i < n; ++i) C[i * n + i] = T(1);
        return 0;
    }
    std::vector<long> full_index(n);
    lu_pivot_rows(A, n, r, full_index.data());
    std::memcpy(index, full_index.data(), r * sizeof(long));
    if (coefficients(A, n, r, index, C) != 0) return 1;
    maxvol_iterate(C, n, r, tol_d, max_iters, index);
    return 0;
}

// Rectangular maxvol: from the square maxvol's rows, add the row of largest
// coefficient norm while its squared norm exceeds tol^2, with K kept in
// [minK, maxK]. C is n x maxK (row-major); K_out receives K.
template <typename T>
int rect_maxvol_impl(const T* A, long n, long r, double tol_d, long maxK, long minK,
                     long start_maxvol_iters, long identity_submatrix, long* index, T* C,
                     long* K_out) {
    if (n <= r) {
        for (long i = 0; i < n; ++i) index[i] = i;
        std::memset(C, 0, n * maxK * sizeof(T));
        for (long i = 0; i < n; ++i) C[i * maxK + i] = T(1);
        *K_out = n;
        return 0;
    }
    if (maxK > n) maxK = n;
    if (maxK < r) maxK = r;
    if (minK < r) minK = r;
    if (minK > n) minK = n;
    if (minK > maxK) minK = maxK;

    T tol2 = T(tol_d * tol_d);
    std::vector<T> Csq(n * r);
    std::vector<long> idx0(r);
    if (maxvol_impl<T>(A, n, r, 1.05, start_maxvol_iters, idx0.data(), Csq.data()) != 0)
        return 1;

    std::memset(C, 0, n * maxK * sizeof(T));
    for (long i = 0; i < n; ++i) std::memcpy(&C[i * maxK], &Csq[i * r], r * sizeof(T));

    std::vector<T> chosen(n, T(1));
    for (long j = 0; j < r; ++j) { index[j] = idx0[j]; chosen[idx0[j]] = T(0); }

    std::vector<T> rns(n);
    for (long i = 0; i < n; ++i) {
        T s = T(0);
        for (long j = 0; j < r; ++j) s += C[i * maxK + j] * C[i * maxK + j];
        rns[i] = s * chosen[i];
    }
    long K = r;
    long bi = 0;
    T best = T(-1);
    for (long i = 0; i < n; ++i) if (rns[i] > best) { best = rns[i]; bi = i; }

    std::vector<T> v(n), c(maxK);
    while ((rns[bi] > tol2 && K < maxK) || K < minK) {
        index[K] = bi;
        chosen[bi] = T(0);
        std::memcpy(c.data(), &C[bi * maxK], K * sizeof(T));
        for (long i = 0; i < n; ++i) {
            T s = T(0);
            const T* Ci = &C[i * maxK];
            for (long j = 0; j < K; ++j) s += Ci[j] * c[j];
            v[i] = s;
        }
        T l = T(1) / (T(1) + v[bi]);
        // One pass: the update, the appended column, the row norms and the
        // next argmax
        T nbest = T(-1);
        long nbi = 0;
        for (long i = 0; i < n; ++i) {
            T* Ci = &C[i * maxK];
            T lv = l * v[i];
            for (long j = 0; j < K; ++j) Ci[j] -= lv * c[j];
            Ci[K] = lv;
            T rn = (rns[i] - lv * v[i]) * chosen[i];
            rns[i] = rn;
            if (rn > nbest) { nbest = rn; nbi = i; }
        }
        best = nbest;
        bi = nbi;
        ++K;
    }

    if (identity_submatrix) {
        for (long k = 0; k < K; ++k) {
            T* Ci = &C[index[k] * maxK];
            std::memset(Ci, 0, K * sizeof(T));
            Ci[k] = T(1);
        }
    }
    *K_out = K;
    return 0;
}

}  // namespace

extern "C" {

// maxvol of A (n x r, row-major): r rows (index) and C = A inv(A[rows])
// (n x r). Returns 1 when the LU start's block is exactly singular.
int tnt_maxvol(const double* A, long n, long r, double tol, long max_iters, long* index,
               double* C) {
    return maxvol_impl<double>(A, n, r, tol, max_iters, index, C);
}

int tnt_maxvol_f32(const float* A, long n, long r, double tol, long max_iters, long* index,
                   float* C) {
    return maxvol_impl<float>(A, n, r, tol, max_iters, index, C);
}

// The swap loop alone: C (n x r, row-major) holds A inv(A[index]) on entry;
// C and index (r rows) are updated in place.
int tnt_maxvol_iterate(double* C, long n, long r, double tol, long max_iters, long* index) {
    maxvol_iterate<double>(C, n, r, tol, max_iters, index);
    return 0;
}

int tnt_maxvol_iterate_f32(float* C, long n, long r, double tol, long max_iters,
                           long* index) {
    maxvol_iterate<float>(C, n, r, tol, max_iters, index);
    return 0;
}

// Rectangular maxvol of A (n x r): K rows in index (room for maxK), C as an
// n x maxK workspace whose first K columns hold the result, K in K_out.
// Returns 1 when the square start's block is exactly singular.
int tnt_rect_maxvol(const double* A, long n, long r, double tol, long maxK, long minK,
                    long start_maxvol_iters, long identity_submatrix, long* index, double* C,
                    long* K_out) {
    return rect_maxvol_impl<double>(A, n, r, tol, maxK, minK, start_maxvol_iters,
                                    identity_submatrix, index, C, K_out);
}

int tnt_rect_maxvol_f32(const float* A, long n, long r, double tol, long maxK, long minK,
                        long start_maxvol_iters, long identity_submatrix, long* index,
                        float* C, long* K_out) {
    return rect_maxvol_impl<float>(A, n, r, tol, maxK, minK, start_maxvol_iters,
                                   identity_submatrix, index, C, K_out);
}

}  // extern "C"
