// K3: what the jittered Cholesky does around the factorization itself,
// with its backward. For a (n, n) matrix A and one scale c of the
// ladder,
//
//   pre-pass   s_i = rsqrt(max(|A_ii|, 1e-30))     (equilibrate), or
//              d = |mean(diag A)|                  (otherwise)
//   prologue   M = (A_ij s_i) s_j + c delta_ij     (equilibrate), or
//              M = A + (c d) I                     (otherwise)
//   [torch.linalg.cholesky_ex(M) -> L, info: cuSOLVER's potrf]
//   epilogue   O = L / s[:, None], and one flag: info stays 0 only when
//              every entry of L is finite (otherwise the kernel stores -1
//              into info); without equilibration only the flag
//
// and the backward of the prologue and the epilogue with cotangents
// M-bar and O-bar (torch's Cholesky VJP runs between them):
//
//   epilogue   L-bar = O-bar / s_i,  s-bar_i = -sum_j O-bar_ij L_ij / s_i^2
//   prologue   A-bar_ij = (M-bar_ij s_j) s_i, then
//              s-bar_i += sum_j M-bar_ij A_ij s_j + sum_j M-bar_ji A_ji s_j
//              A-bar_ii += -1/2 s-bar_i s_i^3 sign(A_ii)  where |A_ii| > 1e-30
//              (without equilibration: A-bar = M-bar + c sign(mean diag A)
//              tr(M-bar) / n on the diagonal)
//
// Replaces the XLA code around the Cholesky of runlmc_tpu/lmc/woodbury.py
// :60-124 (chol_jittered: the equilibration, the jitter, the finiteness
// test of each candidate and the de-scaling, and XLA's autodiff of
// them). The factorization stays cuSOLVER's, as the JAX package leaves
// it to XLA.
//
// Bound on the card: bytes. The prologue reads A and writes M (2 n^2
// elements), the epilogue reads L's lower triangle and writes O (1.5
// n^2), the prologue's backward reads M-bar and A and writes A-bar (3
// n^2), the epilogue's reads O-bar and L's lower triangle and writes
// L-bar (2.5 n^2); the operations are a few per element.
//
// Design: 32 x 32 tiles through shared memory wherever two operands or
// an operand and the output differ in storage order (cuSOLVER leaves L
// column-major; the prologue writes M column-major so that cholesky_ex's
// copy of it into its factor is a straight copy; the cotangents come
// row-major or column-major), elementwise passes elsewhere. Products and
// sums that the plain version (torch's elementwise ops) rounds one by one
// are written with __fmul_rn/__fadd_rn so that nvcc contracts none of
// them into an FMA: the forward passes equal their plain versions bit for
// bit. Row and column sums of the backward are per-tile partials (a
// warp's shuffle tree over 32 terms), reduced by one thread per row over
// the tiles in order: no atomics, a second launch is bit-identical. The
// flag is the only cross-CTA result: CTAs that see a non-finite entry
// store the same -1, so it needs no ordering either.

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;          // blockDim.y of a tile CTA (32 x 8 threads)
constexpr int kThreads = 256;     // elementwise and reduction CTAs
constexpr int kPrepass = 1024;    // the one-CTA passes

__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
// torch's rsqrt on the card is the CUDA math library's
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ T tiny() { return T(1e-30); }

template <typename T>
__device__ __forceinline__ T sign_of(T a) {
    return a > T(0) ? T(1) : (a < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

// One CTA's sum of a[i * stride] over i < n in a fixed order: each
// thread its strided share, then a shared-memory tree.
template <typename T>
__device__ T block_sum(const T* a, int64_t stride, int64_t n, T* red) {
    T acc = T(0);
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) acc += a[i * stride];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    const T total = red[0];
    __syncthreads();
    return total;
}

// pre-pass, one CTA: s (n) with equilibration, else d = |mean diag A| (1)
template <typename T>
__global__ void k3_scale_kernel(const T* __restrict__ A, T* __restrict__ sd,
                             int64_t n, int equil) {
    __shared__ T red[kPrepass];
    if (equil) {
        for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
            const T a = fabs(A[i * (n + 1)]);
            // torch.clamp keeps a NaN, as this comparison does
            sd[i] = rsqrt_t(a < tiny<T>() ? tiny<T>() : a);
        }
        return;
    }
    const T total = block_sum(A, n + 1, n, red);
    if (threadIdx.x == 0) sd[0] = fabs(total / T(n));
}

// prologue: A row-major in, M column-major out (a tile transposed through
// shared memory); with equilibration also a copy of s into s_out, the
// differentiable s of this attempt
template <typename T>
__global__ void k3_prologue_kernel(const T* __restrict__ A,
                                const T* __restrict__ sd, T* __restrict__ M,
                                T* __restrict__ s_out, int64_t n, int equil,
                                double scale) {
    __shared__ T tile[kTile][kTile + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t i0 = (int64_t)blockIdx.y * kTile;
    const int64_t j0 = (int64_t)blockIdx.x * kTile;
    const T cd = equil ? T(scale) : mul_rn(T(scale), sd[0]);
    const int64_t j = j0 + tx;
    const T sj = (equil && j < n) ? sd[j] : T(1);
    for (int r = ty; r < kTile; r += kRows) {
        const int64_t i = i0 + r;
        if (i < n && j < n) {
            T v = A[i * n + j];
            if (equil) v = mul_rn(mul_rn(v, sd[i]), sj);
            tile[r][tx] = add_rn(v, i == j ? cd : T(0));
        }
    }
    if (equil && blockIdx.y == 0 && ty == 0 && j < n) s_out[j] = sj;
    __syncthreads();
    // M_ij goes to j * n + i: consecutive lanes take consecutive rows
    const int64_t i = i0 + tx;
    for (int c = ty; c < kTile; c += kRows) {
        const int64_t jj = j0 + c;
        if (i < n && jj < n) M[jj * n + i] = tile[tx][c];
    }
}

// epilogue, elementwise over L's storage (column-major when lcol): the
// lower triangle is read and de-scaled, the upper written as 0 / s_i
// (cholesky_ex leaves it zero); O null: the flag alone
template <typename T>
__global__ void k3_descale_kernel(const T* __restrict__ L,
                               const T* __restrict__ s, T* __restrict__ O,
                               int* __restrict__ flag, int64_t n, int lcol) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    bool bad = false;
    for (int64_t r = blockIdx.y; r < n; r += gridDim.y) {
        if (c >= n) break;
        const int64_t i = lcol ? c : r, j = lcol ? r : c;
        const int64_t p = r * n + c;
        T v = T(0);
        if (j <= i) {
            v = L[p];
            bad |= !isfinite(v);
        }
        if (O != nullptr) O[p] = v / s[i];
    }
    if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = -1;
}

// Load a 32 x 32 tile (rows i0.., columns j0..) of X, stored row-major or
// column-major (xcol), into t[r][c]; entries past n (and, with lower,
// those above the diagonal) read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(T (*t)[kTile + 1],
                                          const T* __restrict__ X, int xcol,
                                          int64_t i0, int64_t j0, int64_t n,
                                          bool lower) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int r = ty; r < kTile; r += kRows) {
        // row-major: lane tx on column j0 + tx of row i0 + r; column-major:
        // lane tx on row i0 + tx of column j0 + r
        const int64_t i = xcol ? i0 + tx : i0 + r;
        const int64_t j = xcol ? j0 + r : j0 + tx;
        T v = T(0);
        if (i < n && j < n && !(lower && j > i)) {
            v = xcol ? X[j * n + i] : X[i * n + j];
        }
        if (xcol) t[tx][r] = v; else t[r][tx] = v;
    }
}

// The tile pass of both backwards. PRO: the prologue's (X = M-bar, Y = A,
// out = A-bar without its diagonal term, row and column partials of
// (X Y)_ij s_j and (X Y)_ij s_i); else the epilogue's (X = O-bar, Y = L's
// lower triangle, out = L-bar, row partials of (X Y)_ij). out is stored
// row-major or column-major (ocol). Partials: rowpart[tile column][row]
// and colpart[tile row][column].
template <typename T, bool PRO>
__global__ void k3_tile_bwd_kernel(const T* __restrict__ X, int xcol,
                                const T* __restrict__ Y, int ycol,
                                const T* __restrict__ s, T* __restrict__ out,
                                int ocol, T* __restrict__ rowpart,
                                T* __restrict__ colpart, int64_t n) {
    __shared__ T xs[kTile][kTile + 1];
    __shared__ T ys[kTile][kTile + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t i0 = (int64_t)blockIdx.y * kTile;
    const int64_t j0 = (int64_t)blockIdx.x * kTile;
    load_tile(xs, X, xcol, i0, j0, n, false);
    if (PRO || j0 <= i0 + kTile - 1) {
        load_tile(ys, Y, ycol, i0, j0, n, !PRO);
    } else {
        for (int r = ty; r < kTile; r += kRows) ys[r][tx] = T(0);
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += kRows) {
        const int64_t i = ocol ? i0 + tx : i0 + r;
        const int64_t j = ocol ? j0 + r : j0 + tx;
        if (i < n && j < n) {
            const T x = ocol ? xs[tx][r] : xs[r][tx];
            out[ocol ? j * n + i : i * n + j] =
                PRO ? mul_rn(mul_rn(x, s[j]), s[i]) : x / s[i];
        }
    }
    // the products, in place of Y (each entry its own thread's)
    for (int r = ty; r < kTile; r += kRows) ys[r][tx] = xs[r][tx] * ys[r][tx];
    __syncthreads();
    const bool jin = j0 + tx < n, iin = i0 + tx < n;
    for (int r = ty; r < kTile; r += kRows) {
        T v = ys[r][tx];
        if (PRO) v = jin ? v * s[j0 + tx] : T(0);
        v = warp_sum(v);
        if (tx == 0 && i0 + r < n) rowpart[blockIdx.x * n + i0 + r] = v;
    }
    if (PRO) {
        for (int c = ty; c < kTile; c += kRows) {
            T v = iin ? ys[tx][c] * s[i0 + tx] : T(0);
            v = warp_sum(v);
            if (tx == 0 && j0 + c < n) colpart[blockIdx.y * n + j0 + c] = v;
        }
    }
}

// the partials summed over the tiles in order, one thread per row: the
// epilogue's s-bar, or the prologue's s-bar (with the epilogue's sbar_in)
// and its diagonal term added to A-bar
template <typename T, bool PRO>
__global__ void k3_reduce_kernel(const T* __restrict__ rowpart,
                              const T* __restrict__ colpart, int64_t tiles,
                              const T* __restrict__ sbar_in,
                              const T* __restrict__ s,
                              const T* __restrict__ A, T* __restrict__ sbar,
                              T* __restrict__ Abar, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    T acc = T(0);
    for (int64_t b = 0; b < tiles; ++b) acc += rowpart[b * n + i];
    const T si = s[i];
    if (!PRO) {
        sbar[i] = -acc / (si * si);
        return;
    }
    T col = T(0);
    for (int64_t b = 0; b < tiles; ++b) col += colpart[b * n + i];
    const T sb = (sbar_in != nullptr ? sbar_in[i] : T(0)) + acc + col;
    const T a = A[i * (n + 1)];
    if (fabs(a) > tiny<T>()) {
        Abar[i * (n + 1)] += (T(-0.5) * sb * (si * si * si)) * sign_of(a);
    }
}

// without equilibration: g = tr(M-bar) c sign(sum diag A) / n, one CTA
template <typename T>
__global__ void k3_trace_kernel(const T* __restrict__ Mbar,
                             const T* __restrict__ A, T* __restrict__ g,
                             int64_t n, double scale) {
    __shared__ T red[kPrepass];
    const T tr = block_sum(Mbar, n + 1, n, red);
    const T sa = block_sum(A, n + 1, n, red);
    if (threadIdx.x == 0) g[0] = ((tr * T(scale)) * sign_of(sa)) / T(n);
}

// out = X + g delta, elementwise over X's storage (the diagonal sits at
// the same place in either order)
template <typename T>
__global__ void k3_add_diag_kernel(const T* __restrict__ X,
                                const T* __restrict__ g, T* __restrict__ out,
                                int64_t n) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n) return;
    const T gv = g[0];
    for (int64_t r = blockIdx.y; r < n; r += gridDim.y) {
        const int64_t p = r * n + c;
        out[p] = add_rn(X[p], r == c ? gv : T(0));
    }
}

inline int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

inline dim3 tile_grid(int64_t n) {
    return dim3((unsigned)tiles_of(n), (unsigned)tiles_of(n));
}

inline dim3 rows_grid(int64_t n) {
    return dim3((unsigned)((n + kThreads - 1) / kThreads), runlmc::grid_y(n));
}

}  // namespace

template <typename T>
static int prologue(const T* A, T* sd, T* M, T* s_out, int64_t n, int equil,
                    double scale, int prepass, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (prepass) k3_scale_kernel<T><<<1, kPrepass, 0, st>>>(A, sd, n, equil);
    k3_prologue_kernel<T><<<tile_grid(n), dim3(kTile, kRows), 0, st>>>(
        A, sd, M, s_out, n, equil, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int descale(const T* L, const T* s, T* O, int* flag, int64_t n,
                   int lcol, void* stream) {
    k3_descale_kernel<T><<<rows_grid(n), kThreads, 0,
                           (cudaStream_t)stream>>>(L, s, O, flag, n, lcol);
    return (int)cudaGetLastError();
}

template <typename T>
static int descale_bwd(const T* Obar, int ocol, const T* L, int lcol,
                       const T* s, T* Lbar, T* sbar, T* part, int64_t n,
                       void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    k3_tile_bwd_kernel<T, false><<<tile_grid(n), dim3(kTile, kRows), 0,
                                   st>>>(Obar, ocol, L, lcol, s, Lbar, ocol,
                                         part, nullptr, n);
    k3_reduce_kernel<T, false><<<(unsigned)((n + kThreads - 1) / kThreads),
                              kThreads, 0, st>>>(
        part, nullptr, tiles_of(n), nullptr, s, nullptr, sbar, nullptr, n);
    return (int)cudaGetLastError();
}

template <typename T>
static int prologue_bwd(const T* Mbar, int mcol, const T* A, const T* s,
                        const T* sbar_in, T* Abar, T* part, int64_t n,
                        int equil, double scale, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (!equil) {
        // part[0]: g
        k3_trace_kernel<T><<<1, kPrepass, 0, st>>>(Mbar, A, part, n, scale);
        k3_add_diag_kernel<T><<<rows_grid(n), kThreads, 0, st>>>(Mbar, part,
                                                              Abar, n);
        return (int)cudaGetLastError();
    }
    const int64_t nt = tiles_of(n);
    T* rowpart = part;
    T* colpart = part + nt * n;
    k3_tile_bwd_kernel<T, true><<<tile_grid(n), dim3(kTile, kRows), 0,
                                  st>>>(Mbar, mcol, A, 0, s, Abar, 0, rowpart,
                                        colpart, n);
    k3_reduce_kernel<T, true><<<(unsigned)((n + kThreads - 1) / kThreads),
                             kThreads, 0, st>>>(
        rowpart, colpart, nt, sbar_in, s, A, nullptr, Abar, n);
    return (int)cudaGetLastError();
}

#define K3_ENTRIES(T, SFX)                                                    \
    extern "C" int k3_prologue_##SFX(const T* A, T* sd, T* M, T* s_out,       \
                                     int64_t n, int equil, double scale,      \
                                     int prepass, void* stream) {             \
        return prologue<T>(A, sd, M, s_out, n, equil, scale, prepass,         \
                           stream);                                           \
    }                                                                         \
    extern "C" int k3_descale_##SFX(const T* L, const T* s, T* O, int* flag,  \
                                    int64_t n, int lcol, void* stream) {      \
        return descale<T>(L, s, O, flag, n, lcol, stream);                    \
    }                                                                         \
    extern "C" int k3_descale_bwd_##SFX(const T* Obar, int ocol, const T* L,  \
                                        int lcol, const T* s, T* Lbar,        \
                                        T* sbar, T* part, int64_t n,          \
                                        void* stream) {                       \
        return descale_bwd<T>(Obar, ocol, L, lcol, s, Lbar, sbar, part, n,    \
                              stream);                                        \
    }                                                                         \
    extern "C" int k3_prologue_bwd_##SFX(const T* Mbar, int mcol, const T* A, \
                                         const T* s, const T* sbar_in,        \
                                         T* Abar, T* part, int64_t n,         \
                                         int equil, double scale,             \
                                         void* stream) {                      \
        return prologue_bwd<T>(Mbar, mcol, A, s, sbar_in, Abar, part, n,      \
                               equil, scale, stream);                         \
    }

K3_ENTRIES(float, f32)
K3_ENTRIES(double, f64)
