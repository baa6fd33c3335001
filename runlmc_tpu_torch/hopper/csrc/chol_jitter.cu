// K3: what the jittered Cholesky does around the factorization itself,
// with its backward. For a (n, n) matrix A and one scale c of the
// ladder,
//
//   scale      s_i = rsqrt(max(|A_ii|, 1e-30))     (equilibrate), or
//              d = |mean(diag A)|                  (otherwise, a pre-pass)
//   prologue   M = (A_ij s_i) s_j + c delta_ij     (equilibrate), or
//              M = A + (c d) I                     (otherwise),
//              M's lower triangle, zeros above it
//   [cuSOLVER's potrf factors M in place: L = M, info]
//   epilogue   O = L / s[:, None] with zeros above the diagonal, and one
//              flag: info stays 0 only when every entry of L's lower
//              triangle is finite (otherwise the kernel stores -1 into
//              info); without equilibration only the flag
//
// and the backward of the prologue and the epilogue with cotangents
// M-bar and O-bar (the Cholesky VJP runs between them):
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
// Bound on the card: bytes. The prologue reads A's lower triangle and
// writes M (1.5 n^2 elements), the epilogue reads L's lower triangle and
// writes O (1.5 n^2), the prologue's backward reads M-bar and A and
// writes A-bar (3 n^2), the epilogue's reads O-bar and L's lower
// triangle and writes L-bar (2.5 n^2); the operations are a few per
// element.
//
// Design. The prologue is persistent (CTAs sized by the occupancy API)
// over the 64 x 64 tiles of M: potrf reads only M's lower triangle, so
// no tile of A above the diagonal is read, and the tiles of M above it
// are stores of zeros (potrf, called in place, leaves them as the
// factor's upper triangle: no tril_ after it). It transposes each lower
// tile through shared memory (A row-major, M column-major, potrf's
// storage, so that potrf factors M where it lies) and recomputes
// the tile's own s_i and s_j from A's diagonal on the first attempt
// (elementwise: the same bits as a pre-pass). The epilogue works along
// L's storage lines. Both move 16-byte vectors, several loads in flight
// a thread before any store. No row of an n x n matrix need start on a
// 16-byte boundary (n = 3094 floats start every other row 8 bytes off),
// so each line is split at its own boundaries: scalar head, vector body,
// scalar tail. Products and sums that the plain version (torch's
// elementwise ops) rounds one by one are written with __fmul_rn/__fadd_rn
// so that nvcc contracts none of them into an FMA, and the de-scale
// divides as torch does: the forward passes equal their plain versions
// bit for bit. The backward runs 32 x 32 tiles through shared memory
// wherever two operands or an operand and the output differ in storage
// order (the cotangents come row-major or column-major), elementwise
// passes elsewhere. Its row and column sums are per-tile partials (a
// warp's shuffle tree over 32 terms), reduced by one thread per row over
// the tiles in order: no atomics, a second launch is bit-identical. The
// flag is the only cross-CTA result: CTAs that see a non-finite entry
// store the same -1, so it needs no ordering either.

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kTile = 32;         // the backward's tiles
constexpr int kRows = 8;          // blockDim.y of a tile CTA (32 x 8 threads)
constexpr int kThreads = 256;     // elementwise and reduction CTAs
constexpr int kPrepass = 1024;    // the one-CTA passes
constexpr int kT = 64;            // K3a's tiles
constexpr int kThreadsA = 256;    // a K3a CTA
constexpr int kThreadsB = 128;    // a K3b CTA
constexpr int kUnrollB = 4;       // K3b's vectors a thread (loads in flight)
constexpr int kMaxDevices = 16;

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

// pre-pass without equilibration, one CTA: d = |mean diag A| (1)
template <typename T>
__global__ void k3_scale_kernel(const T* __restrict__ A, T* __restrict__ sd,
                                int64_t n) {
    __shared__ T red[kPrepass];
    const T total = block_sum(A, n + 1, n, red);
    if (threadIdx.x == 0) sd[0] = fabs(total / T(n));
}

// 16-byte accesses: 4 floats or 2 doubles
__device__ __forceinline__ void ld16(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld16(const double* p, double* v) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// A line of len contiguous elements at p, split at its 16-byte
// boundaries: head scalars, nv whole vectors, then the tail; ns scalars
// in head and tail together (fewer than 2 V). Scalar u (< ns) sits at
// position pos(u).
template <typename T>
struct Split {
    static constexpr int V = 16 / sizeof(T);
    int head, nv, ns;
    __device__ __forceinline__ Split(const T* p, int len) {
        const int mis = (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T))
                              % V);
        head = min((V - mis) % V, len);
        nv = (len - head) / V;
        ns = len - nv * V;
    }
    __device__ __forceinline__ int pos(int u) const {
        return u < head ? u : u + nv * V;
    }
};

// t-th tile of the lower block triangle, row by row: (bi, bj), bj <= bi
__device__ __forceinline__ void tri_tile(int64_t t, int64_t& bi,
                                         int64_t& bj) {
    int64_t b = (int64_t)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while (b * (b + 1) / 2 > t) --b;
    while ((b + 1) * (b + 2) / 2 <= t) ++b;
    bi = b;
    bj = t - b * (b + 1) / 2;
}

template <typename T>
__device__ __forceinline__ T m_entry(T a, T si, T sj, bool diag, T cd,
                                     int equil) {
    const T v = equil ? mul_rn(mul_rn(a, si), sj) : a;
    return add_rn(v, diag ? cd : T(0));
}

// K3a, persistent: each CTA takes the kT x kT tiles t = blockIdx.x,
// + gridDim.x, ... of M: first the nlower tiles of its lower block
// triangle (diagonal tiles whole), then those above it. A lower tile
// reads its rows of A (row-major) into shared memory and writes its
// columns of M (column-major), zeros above the diagonal; a tile above
// the diagonal is stores of zeros, with no load. A line (a row of A's
// tile, a column of M's) is G threads: thread k its k-th 16-byte
// vector, the threads past the vectors the line's head and tail
// scalars; each thread takes P lines of a tile, loads first. With
// equilibration the tile's s_i and s_j are rsqrt(max(|A_ii|, 1e-30)) of
// A's own diagonal on the first attempt (prepass; diagonal tiles store
// them into sd) and sd's later; diagonal tiles also store the attempt's
// copy s_out.
template <typename T>
__global__ void __launch_bounds__(kThreadsA)
k3_prologue_kernel(const T* __restrict__ A, T* __restrict__ sd,
                   T* __restrict__ M, T* __restrict__ s_out, int64_t n,
                   int equil, int prepass, double scale, int64_t nlower,
                   int64_t ntiles) {
    constexpr int V = Split<T>::V;
    constexpr int G = kT / V;            // threads on a line
    constexpr int LP = kThreadsA / G;    // lines at once
    constexpr int P = kT / LP;           // lines a thread takes
    __shared__ T tile[kT][kT + 1];
    __shared__ T sr[kT], sc[kT];
    const int k = threadIdx.x % G, l0 = threadIdx.x / G;
    const T cd = equil ? T(scale) : mul_rn(T(scale), sd[0]);
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
        int64_t bi, bj;
        if (t < nlower) {
            tri_tile(t, bi, bj);
        } else {  // (a, b), b <= a, names the tile (b, a + 1) above
            tri_tile(t - nlower, bj, bi);
            ++bj;
        }
        const int64_t i0 = bi * kT, j0 = bj * kT;
        const int rows = (int)(n - i0 < kT ? n - i0 : kT);
        const int cols = (int)(n - j0 < kT ? n - j0 : kT);
        if (t >= nlower) {  // the same for the whole CTA: no barrier
            const T zero[V] = {};
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int c = l0 + p * LP;
                if (c < cols) {
                    T* dst = M + (j0 + c) * n + i0;
                    const Split<T> sp(dst, rows);
                    if (k < sp.nv) {
                        st16(dst + sp.head + k * V, zero);
                    } else {
                        for (int u = k - sp.nv; u < sp.ns; u += G - sp.nv) {
                            dst[sp.pos(u)] = T(0);
                        }
                    }
                }
            }
            continue;
        }
        if (equil && threadIdx.x < 2 * kT) {
            const bool isrow = threadIdx.x < kT;
            const int q = threadIdx.x % kT;
            const int64_t i = (isrow ? i0 : j0) + q;
            if (q < (isrow ? rows : cols)) {
                T v;
                if (prepass) {
                    const T a = fabs(A[i * (n + 1)]);
                    // torch.clamp keeps a NaN, as this comparison does
                    v = rsqrt_t(a < tiny<T>() ? tiny<T>() : a);
                } else {
                    v = sd[i];
                }
                (isrow ? sr : sc)[q] = v;
                if (isrow && bi == bj) {
                    s_out[i] = v;
                    if (prepass) sd[i] = v;
                }
            }
        }
        T v[P][V];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int r = l0 + p * LP;
            if (r < rows) {
                const T* src = A + (i0 + r) * n + j0;
                const Split<T> sp(src, cols);
                if (k < sp.nv) ld16(src + sp.head + k * V, v[p]);
            }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int r = l0 + p * LP;
            if (r < rows) {
                const T* src = A + (i0 + r) * n + j0;
                const Split<T> sp(src, cols);
                if (k < sp.nv) {
#pragma unroll
                    for (int e = 0; e < V; ++e) {
                        tile[r][sp.head + k * V + e] = v[p][e];
                    }
                } else {
                    for (int u = k - sp.nv; u < sp.ns; u += G - sp.nv) {
                        const int c = sp.pos(u);
                        tile[r][c] = src[c];
                    }
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int c = l0 + p * LP;
            if (c < cols) {
                const int64_t j = j0 + c;
                T* dst = M + j * n + i0;
                const Split<T> sp(dst, rows);
                const T sj = equil ? sc[c] : T(1);
                if (k < sp.nv) {
                    T w[V];
#pragma unroll
                    for (int e = 0; e < V; ++e) {
                        const int r = sp.head + k * V + e;
                        w[e] = i0 + r < j ? T(0)
                             : m_entry(tile[r][c], equil ? sr[r] : T(1), sj,
                                       i0 + r == j, cd, equil);
                    }
                    st16(dst + sp.head + k * V, w);
                } else {
                    for (int u = k - sp.nv; u < sp.ns; u += G - sp.nv) {
                        const int r = sp.pos(u);
                        dst[r] = i0 + r < j ? T(0)
                               : m_entry(tile[r][c], equil ? sr[r] : T(1),
                                         sj, i0 + r == j, cd, equil);
                    }
                }
            }
        }
        __syncthreads();
    }
}

// K3b over L's storage (column-major when lcol), a line (a column, or a
// row) at a time: CTA (c, r) takes chunk c of line r, kUnrollB vectors a
// thread, every load before the first store; chunk 0 also the line's
// head and tail scalars. Entries of the lower triangle are read, tested
// and de-scaled; a vector wholly above the diagonal is a store of zeros
// with no load, and the entries above the diagonal of a vector that
// straddles it are written as zeros and never tested. O null: the flag
// alone (the lower triangle read, nothing stored).
template <typename T>
__global__ void __launch_bounds__(kThreadsB)
k3_descale_kernel(const T* __restrict__ L, const T* __restrict__ s,
                  T* __restrict__ O, int* __restrict__ flag, int64_t n,
                  int lcol) {
    constexpr int V = Split<T>::V;
    constexpr int CV = kThreadsB * kUnrollB;  // vectors a chunk
    const int c = blockIdx.x;
    bool bad = false;
    for (int64_t r = blockIdx.y; r < n; r += gridDim.y) {
        const T* src = L + r * n;
        T* dst = O == nullptr ? nullptr : O + r * n;
        const Split<T> sp(src, (int)n);
        // the lower triangle of line r: positions q >= r of a column,
        // q <= r of a row
        const int lo = lcol ? (int)r : 0;
        const int hi = lcol ? (int)n - 1 : (int)r;
        T v[kUnrollB][V];
        bool got[kUnrollB];
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
            const int w = c * CV + u * kThreadsB + threadIdx.x;
            const int q0 = sp.head + w * V;
            got[u] = w < sp.nv && q0 + V - 1 >= lo && q0 <= hi;
            if (got[u]) ld16(src + q0, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnrollB; ++u) {
            const int w = c * CV + u * kThreadsB + threadIdx.x;
            if (w >= sp.nv) continue;
            const int q0 = sp.head + w * V;
            T o[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const int q = q0 + e;
                T x = T(0);
                if (got[u] && q >= lo && q <= hi) {
                    x = v[u][e];
                    bad |= !isfinite(x);
                    if (dst != nullptr) x = x / s[lcol ? q : r];
                }
                o[e] = x;
            }
            if (dst != nullptr) st16(dst + q0, o);
        }
        if (c == 0 && threadIdx.x < sp.ns) {
            const int q = sp.pos(threadIdx.x);
            T x = T(0);
            if (q >= lo && q <= hi) {
                x = src[q];
                bad |= !isfinite(x);
                if (dst != nullptr) x = x / s[lcol ? q : r];
            }
            if (dst != nullptr) dst[q] = x;
        }
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

// CTAs of kern (threads each, no dynamic shared memory) resident on the
// current device at once, found once per device
template <typename K>
static int resident_ctas(K kern, int threads, int* facts, int* out) {
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(lock);
    if (facts[dev] == 0) {
        int nsm = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            threads, 0);
        if (err != cudaSuccess) return (int)err;
        facts[dev] = (per_sm > 0 ? per_sm : 1) * nsm;
    }
    *out = facts[dev];
    return 0;
}

template <typename T>
static int prologue(const T* A, T* sd, T* M, T* s_out, int64_t n, int equil,
                    double scale, int prepass, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n <= 0) return 0;
    if (prepass && !equil) {
        k3_scale_kernel<T><<<1, kPrepass, 0, st>>>(A, sd, n);
    }
    static int facts[kMaxDevices] = {};
    int cap = 0;
    const int rc = resident_ctas(k3_prologue_kernel<T>, kThreadsA, facts,
                                 &cap);
    if (rc != 0) return rc;
    const int64_t nt = (n + kT - 1) / kT, nlower = nt * (nt + 1) / 2;
    const unsigned grid = (unsigned)(nt * nt < cap ? nt * nt : cap);
    k3_prologue_kernel<T><<<grid, kThreadsA, 0, st>>>(
        A, sd, M, s_out, n, equil, prepass, scale, nlower, nt * nt);
    return (int)cudaGetLastError();
}

template <typename T>
static int descale(const T* L, const T* s, T* O, int* flag, int64_t n,
                   int lcol, void* stream) {
    if (n <= 0) return 0;
    // elements of a chunk: each line's vectors are at most n / V
    constexpr int64_t chunk = (int64_t)kThreadsB * kUnrollB * (16 / sizeof(T));
    const int64_t chunks = (n + chunk - 1) / chunk;
    k3_descale_kernel<T><<<dim3((unsigned)chunks, runlmc::grid_y(n)),
                           kThreadsB, 0, (cudaStream_t)stream>>>(
        L, s, O, flag, n, lcol);
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
