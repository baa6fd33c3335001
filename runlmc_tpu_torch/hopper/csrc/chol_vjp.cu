// The Cholesky factorization's VJP (K3's backward through the factor):
// for A = L L^T and a cotangent L-bar of L's lower triangle,
//
//   A-bar = 1/2 (X + X^T),  X = L^-T Phi(L^T L-bar) L^-1,
//
// Phi keeping the lower triangle with its diagonal halved, which is what
// XLA's autodiff of jnp.linalg.cholesky computes (its JVP uses Phi and
// jnp.linalg.cholesky symmetrizes its input). Two kernels:
//
//   tri   S = 1/2 (P + P^T),  P = Phi(L^T L-bar): for a >= b
//         G_ab = sum_{k >= a} L_ka L-bar_kb  (only L's and L-bar's lower
//         triangles enter), S_ab = S_ba = G_ab / 2;
//   sym   X <- 1/2 (X + X^T) in place, after the two triangular solves
//         X = L^-T S L^-1 (hopper/chol_vjp.py: cuBLAS's, which measured
//         faster than K5 at these shapes).
//
// Replaces XLA's autodiff of the Cholesky in runlmc_tpu/lmc/woodbury.py:121
// (chol_jittered, on the exact objective's factors F of K_UU and L_C of
// C), where XLA runs a full GEMM L^T L-bar, the triangle ops and two
// n-column triangular solves.
//
// Bound on the card: tri does about n^3 / 3 operations (n^3 / 6
// multiply-adds: the lower triangle of a product whose inner sums start
// at the row index), against reading L's and L-bar's lower triangles and
// writing S (3 n^2 elements in all): operations at 67 TFLOP/s (float32)
// or 34 (float64 outside the tensor cores). sym moves 2 n^2 elements.
//
// Design of tri: a simple tiled SIMT product over the lower-triangular
// pairs of 64 x 64 output tiles (a-tile >= b-tile), the pairs with the
// longest inner range launched first. Each CTA walks k from its a-tile's
// first row to n in steps of 16, stages L[k, a-tile] and L-bar[k, b-tile]
// in shared memory (masked to the lower triangles; each operand read
// row-major or column-major, cuSOLVER leaving L column-major, with the
// threads' load order following the contiguous dimension), and keeps a
// 4 x 4 block of sums per thread in registers; the epilogue writes
// S[a, b] directly and the mirror S[b, a] through a padded shared tile, so
// both stores are coalesced. Every sum runs over k in ascending order:
// no atomics, no split-K, a second launch is bit-identical (resume needs
// that). sym pairs tile (i, j) with tile (j, i) in one CTA, so the update
// in place reads both before it writes either.

#include "common.cuh"

namespace {

constexpr int kT = 64;        // output tile edge
constexpr int kK = 16;        // inner step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 sums each
constexpr int kLd = kT + 1;   // padded row of the staged and epilogue tiles
constexpr int kS = 32;        // sym's tile edge
constexpr int kSRows = 8;     // blockDim.y of a sym CTA

// (a-tile, b-tile) of the p-th lower-triangular pair, a-tile >= b-tile,
// enumerated row by row: (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void pair_of(int64_t p, int& ta, int& tb) {
    int t = (int)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
    while ((int64_t)(t + 1) * (t + 2) / 2 <= p) ++t;
    while ((int64_t)t * (t + 1) / 2 > p) --t;
    ta = t;
    tb = (int)(p - (int64_t)t * (t + 1) / 2);
}

// X[k, c] of a lower-triangular operand (zero above the diagonal and out
// of range), stored row-major or column-major
template <typename T, bool COL>
__device__ __forceinline__ T lower_at(const T* __restrict__ X, int64_t n,
                                      int k, int c) {
    if (k >= n || c >= n || k < c) return T(0);
    return COL ? X[(int64_t)c * n + k] : X[(int64_t)k * n + c];
}

template <typename T, bool LCOL, bool GCOL>
__global__ void __launch_bounds__(kThreads)
tri_kernel(const T* __restrict__ L, const T* __restrict__ Lb,
           T* __restrict__ S, int n) {
    __shared__ T smem[kT * kLd];
    T* As = smem;            // [kK][kLd]: L[k0 + kk, a0 + aa]
    T* Bs = smem + kK * kLd; // [kK][kLd]: L-bar[k0 + kk, b0 + bb]
    // pairs in row order: the longest inner ranges (small a-tiles) first
    int ta, tb;
    pair_of((int64_t)blockIdx.x, ta, tb);
    const int a0 = ta * kT, b0 = tb * kT;
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    for (int k0 = a0; k0 < n; k0 += kK) {
#pragma unroll
        for (int r = 0; r < kK * kT / kThreads; ++r) {
            const int e = tid + r * kThreads;
            // the element each thread stages follows the operand's
            // contiguous dimension: coalesced in either storage order
            const int kk_l = LCOL ? (e % kK) : (e / kT);
            const int cc_l = LCOL ? (e / kK) : (e % kT);
            As[kk_l * kLd + cc_l] = lower_at<T, LCOL>(L, n, k0 + kk_l,
                                                     a0 + cc_l);
            const int kk_g = GCOL ? (e % kK) : (e / kT);
            const int cc_g = GCOL ? (e / kK) : (e % kT);
            Bs[kk_g * kLd + cc_g] = lower_at<T, GCOL>(Lb, n, k0 + kk_g,
                                                     b0 + cc_g);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
            T av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = As[kk * kLd + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * kLd + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
    }
    // S[a, b] = G_ab / 2 for a >= b (the diagonal tile's upper half is
    // not G's), straight from the registers
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int a = a0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int b = b0 + tx + 16 * j;
            const T v = T(0.5) * acc[i][j];
            smem[(ty + 16 * i) * kLd + tx + 16 * j] = v;
            if (a < n && b < n && a >= b) S[(int64_t)a * n + b] = v;
        }
    }
    __syncthreads();
    // the mirror S[b, a] = S[a, b] for a > b, rows of b read down the
    // padded tile's columns
    for (int e = tid; e < kT * kT; e += kThreads) {
        const int bl = e / kT, al = e % kT;
        const int a = a0 + al, b = b0 + bl;
        if (a < n && b < n && a > b) {
            S[(int64_t)b * n + a] = smem[al * kLd + bl];
        }
    }
}

// X <- (X + X^T) / 2 in place: CTA (i, j), i >= j, reads tiles (i, j) and
// (j, i) into shared memory, then writes both; each entry and its mirror
// are the same sum (X_ij + X_ji = X_ji + X_ij), so the result is exactly
// symmetric
template <typename T>
__global__ void sym_kernel(T* __restrict__ X, int n) {
    __shared__ T tA[kS][kS + 1];
    __shared__ T tB[kS][kS + 1];
    int ti, tj;
    pair_of((int64_t)blockIdx.x, ti, tj);
    const int i0 = ti * kS, j0 = tj * kS;
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int r = ty; r < kS; r += kSRows) {
        const int ia = i0 + r, ja = j0 + tx;  // tile (i, j)
        tA[r][tx] = (ia < n && ja < n) ? X[(int64_t)ia * n + ja] : T(0);
        const int ib = j0 + r, jb = i0 + tx;  // tile (j, i)
        tB[r][tx] = (ib < n && jb < n) ? X[(int64_t)ib * n + jb] : T(0);
    }
    __syncthreads();
    for (int r = ty; r < kS; r += kSRows) {
        const int ia = i0 + r, ja = j0 + tx;
        if (ia < n && ja < n) {
            X[(int64_t)ia * n + ja] = T(0.5) * (tA[r][tx] + tB[tx][r]);
        }
        const int ib = j0 + r, jb = i0 + tx;
        if (ti != tj && ib < n && jb < n) {
            X[(int64_t)ib * n + jb] = T(0.5) * (tB[r][tx] + tA[tx][r]);
        }
    }
}

template <typename T>
int tri(const T* L, int lcol, const T* Lb, int gcol, T* S, int64_t n,
        void* stream) {
    if (n < 0 || n > 0x7fffffff / 2) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int nt = (int)((n + kT - 1) / kT);
    const int64_t pairs = (int64_t)nt * (nt + 1) / 2;
    if (pairs > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)pairs);
    cudaStream_t st = (cudaStream_t)stream;
    const int ni = (int)n;
    if (lcol && gcol) {
        tri_kernel<T, true, true><<<grid, kThreads, 0, st>>>(L, Lb, S, ni);
    } else if (lcol) {
        tri_kernel<T, true, false><<<grid, kThreads, 0, st>>>(L, Lb, S, ni);
    } else if (gcol) {
        tri_kernel<T, false, true><<<grid, kThreads, 0, st>>>(L, Lb, S, ni);
    } else {
        tri_kernel<T, false, false><<<grid, kThreads, 0, st>>>(L, Lb, S, ni);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int sym(T* X, int64_t n, void* stream) {
    if (n < 0 || n > 0x7fffffff / 2) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int64_t nt = (n + kS - 1) / kS;
    const int64_t pairs = nt * (nt + 1) / 2;
    if (pairs > 0x7fffffff) return (int)cudaErrorInvalidValue;
    sym_kernel<T><<<(unsigned)pairs, dim3(kS, kSRows), 0,
                    (cudaStream_t)stream>>>(X, (int)n);
    return (int)cudaGetLastError();
}

}  // namespace

#define CHOL_VJP_ENTRIES(T, SFX)                                              \
    extern "C" int chol_vjp_tri_##SFX(const T* L, int lcol, const T* Lb,      \
                                      int gcol, T* S, int64_t n,              \
                                      void* stream) {                         \
        return tri<T>(L, lcol, Lb, gcol, S, n, stream);                       \
    }                                                                         \
    extern "C" int chol_vjp_sym_##SFX(T* X, int64_t n, void* stream) {        \
        return sym<T>(X, n, stream);                                          \
    }

CHOL_VJP_ENTRIES(float, f32)
CHOL_VJP_ENTRIES(double, f64)
