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
// bit for bit. The backward is persistent too, each CTA on whole storage
// lines of the output (rows of A-bar; rows or columns of L-bar, as O-bar
// lies). Where the cotangent and the other factor lie alike (on the
// training path M-bar and A are both row-major) the line pass reads them
// with no transpose: every line starts on a multiple of gcd(n, V)
// elements, so each thread owns the same positions of every line,
// accessed gcd(n, V) elements at a time (16 bytes where n allows), and
// keeps their cross sums and s in registers; its CTAs run lines with no
// barrier between them. Otherwise (O-bar row-major against potrf's
// column-major L, or a column-major M-bar) the tile pass takes strips of
// kRT lines and brings the other operand through shared memory in
// kCT-wide chunks. A sum along a line (A-bar's row sums, s-bar where
// O-bar is row-major) closes inside its CTA in a fixed order; a sum
// across lines (A-bar's column sums, s-bar where O-bar is column-major)
// is a per-CTA partial, written once per CTA and summed by a small
// finishing pass, which also adds s-bar's term to A-bar's diagonal: one
// launch, or two where there are cross sums. No atomics: a second launch
// is bit-identical. A-bar's off-diagonal entries round as (M-bar_ij s_j)
// s_i, as the plain version does; L-bar is O-bar / s (the line pass
// multiplies by 1 / s, within an ulp of it). The flag is the only
// cross-CTA result of the forward: CTAs that see a non-finite entry
// store the same -1, so it needs no ordering either.

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // elementwise CTAs, and a backward CTA
constexpr int kLineCtas = 2;      // the line pass's CTAs an SM (registers)
constexpr int kRT = 16;           // the tile pass's strips: lines
constexpr int kCT = 128;          // its chunks: positions
constexpr int kFinCols = 32;      // the finishing pass: columns a CTA,
constexpr int kFinLanes = 32;     // partial rows summed side by side,
constexpr int kFinUnroll = 8;     // and loads in flight a thread
constexpr int kPanelBytes = 128 * 1024;  // the tile pass's cross sums
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

// The backward passes. A line is a storage line of the output (a row of
// a row-major matrix, a column of a column-major one), q a position on
// it. G is the cotangent (M-bar or O-bar), F the other factor (A, or L's
// lower triangle), out (A-bar or L-bar) stored like G. PRO: the
// prologue's (lines are rows i, positions columns j):
//   out = (G s_q) s_l,  line sum  sum_q G F s_q,  cross sum  sum_l G F s_l
// else the epilogue's, LR when lines are rows (the lower triangle is
// q <= l) and otherwise columns (q >= l):
//   out = G / s_row,    s-bar's sum of G F over the row: a line sum when
//                       LR, a cross sum otherwise
// A line sum closes inside the CTA that owns the line. A cross sum is a
// per-CTA partial (in registers in the line pass, in shared memory in
// the tile pass), summed over the CTA's lines in order, written as one
// row of part, and summed over the CTAs by the finishing pass in a fixed
// order: no atomics anywhere.
template <bool PRO, bool LR>
struct Sums {
    static constexpr bool kCross = PRO || !LR;  // sums across lines
    static constexpr bool kLine = PRO || LR;    // sums along a line
};

// F's entry (row, col) of the lower triangle, for the epilogue
template <bool PRO, bool LR>
__device__ __forceinline__ bool lower(int64_t l, int64_t q) {
    return PRO || (LR ? q <= l : q >= l);
}

// W-element accesses (W = gcd(n, V): 16, 8 or sizeof(T) bytes)
template <int W, typename T>
__device__ __forceinline__ void ldw(const T* p, T* v) {
    if constexpr (W * sizeof(T) == 16) {
        ld16(p, v);
    } else if constexpr (W * sizeof(T) == 8 && sizeof(T) == 4) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(p));
        v[0] = x.x;
        v[1] = x.y;
    } else {
        v[0] = __ldg(p);
    }
}
template <int W, typename T>
__device__ __forceinline__ void stw(T* p, const T* v) {
    if constexpr (W * sizeof(T) == 16) {
        st16(p, v);
    } else if constexpr (W * sizeof(T) == 8 && sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        *p = v[0];
    }
}

// elements of each line a thread takes in a panel of the line pass
template <typename T>
__host__ __device__ constexpr int line_elems() {
    return sizeof(T) == 4 ? 16 : 8;
}

// The backward for G, F and out stored alike, persistent: CTA b takes
// lines b, b + gridDim.x, ..., all its threads on each line, with no
// barrier between lines, so its warps run lines apart and keep loads in
// flight. Every line starts on a multiple of W elements (W = gcd(n, V):
// the base pointers are on 16-byte boundaries), so each thread owns the
// same positions of every line, W-element accesses p0 + (j kThreads +
// tid) W, j < line_elems / W, of the panel at p0 (kThreads line_elems
// positions): every load of a line issued before any store, F's
// accesses wholly above the diagonal not loaded, and the cross sums and
// s (or 1 / s) of its positions in registers. Line sums: each warp's
// share into wpart (dynamic shared memory, a CTA's lines x NW), summed
// in warp order at the end of the panel and carried across panels in
// lsum; cross sums: the thread's own, each over the CTA's lines in
// order, written as the CTA's row of part.
template <typename T, bool PRO, bool LR, int W>
__global__ void __launch_bounds__(kThreads, kLineCtas)
k3_line_bwd_kernel(const T* __restrict__ G, const T* __restrict__ F,
                   const T* __restrict__ s, T* __restrict__ out,
                   T* __restrict__ lsum, T* __restrict__ sbar,
                   T* __restrict__ part, int64_t n) {
    using S = Sums<PRO, LR>;
    constexpr int J = line_elems<T>() / W;  // a thread's accesses a line
    constexpr int NW = kThreads / 32;
    constexpr int64_t panel = (int64_t)kThreads * line_elems<T>();
    extern __shared__ __align__(16) unsigned char k3_dyn[];
    T* wpart = reinterpret_cast<T*>(k3_dyn);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int64_t p0 = 0; p0 < n; p0 += panel) {
        const bool last = p0 + panel >= n;
        T sq[J][W], cacc[J][W];
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int64_t q0 = p0 + ((int64_t)j * kThreads + tid) * W;
#pragma unroll
            for (int e = 0; e < W; ++e) {
                cacc[j][e] = T(0);
                sq[j][e] = T(1);
                if (q0 < n && (PRO || !LR)) {
                    sq[j][e] = PRO ? s[q0 + e] : T(1) / s[q0 + e];
                }
            }
        }
        int nl = 0;  // this CTA's lines
        for (int64_t l = blockIdx.x; l < n; l += gridDim.x, ++nl) {
            const int64_t off = l * n;
            T x[J][W], y[J][W];
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const int64_t q0 = p0 + ((int64_t)j * kThreads + tid) * W;
                if (q0 < n) {  // W divides n
                    ldw<W>(G + off + q0, x[j]);
                    // an access with an entry of the lower triangle
                    if (lower<PRO, LR>(l, LR ? q0 : q0 + W - 1)) {
                        ldw<W>(F + off + q0, y[j]);
                    } else {
#pragma unroll
                        for (int e = 0; e < W; ++e) y[j][e] = T(0);
                    }
                }
            }
            const T sl = s[l], rl = T(1) / sl;
            T lacc = T(0);
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const int64_t q0 = p0 + ((int64_t)j * kThreads + tid) * W;
                if (q0 >= n) continue;
                T o[W];
#pragma unroll
                for (int e = 0; e < W; ++e) {
                    const T g = x[j][e];
                    const T f = lower<PRO, LR>(l, q0 + e) ? y[j][e] : T(0);
                    const T pr = g * f;
                    if (PRO) {
                        o[e] = mul_rn(mul_rn(g, sq[j][e]), sl);
                        lacc += pr * sq[j][e];
                        cacc[j][e] += pr * sl;
                    } else {
                        o[e] = g * (LR ? rl : sq[j][e]);
                        if (LR) lacc += pr; else cacc[j][e] += pr;
                    }
                }
                stw<W>(out + off + q0, o);
            }
            if (S::kLine) {
                lacc = warp_sum(lacc);
                if (lane == 0) wpart[nl * NW + warp] = lacc;
            }
        }
        __syncthreads();
        if (S::kLine) {
            for (int i = tid; i < nl; i += kThreads) {
                const int64_t l = blockIdx.x + (int64_t)i * gridDim.x;
                T t = wpart[i * NW];
                for (int k = 1; k < NW; ++k) t += wpart[i * NW + k];
                if (p0 > 0) t = lsum[l] + t;
                if (PRO || !last) {
                    lsum[l] = t;
                } else {
                    const T sl = s[l];
                    sbar[l] = -t / (sl * sl);
                }
            }
        }
        if (S::kCross) {
#pragma unroll
            for (int j = 0; j < J; ++j) {
                const int64_t q0 = p0 + ((int64_t)j * kThreads + tid) * W;
                if (q0 < n) stw<W>(part + blockIdx.x * n + q0, cacc[j]);
            }
        }
        __syncthreads();  // wpart is read
    }
}

// The backward when the other factor is stored the other way (PRO:
// M-bar column-major against a row-major A; else L against O-bar), so
// one operand goes through shared memory: X, whose storage line q holds
// the positions l of the strip. Persistent: CTA b takes strips of kRT
// lines b, b + gridDim.x, ..., each in chunks of kCT positions; a warp
// owns kRT / 8 lines of a strip, a lane kCT / 32 positions of a chunk
// (coalesced scalar loads of S, the operand stored like out), and X's
// chunk arrives as kCT segments of kRT contiguous entries, every load of
// a chunk issued before the chunk's first barrier. Two barriers a chunk:
// X's buffer in, and either the buffer free again or, with cross sums,
// the chunk's sums in (X then alternates between two buffers). Line sums stay in the warp that
// owns the line (shuffles), cross sums of a chunk go through shared
// memory into the CTA's partial. PRO: S = A and X = M-bar; else S =
// O-bar and X = L.
template <typename T, bool PRO, bool LR>
__global__ void __launch_bounds__(kThreads, Sums<PRO, LR>::kCross ? 2 : 1)
k3_tile_bwd_kernel(const T* __restrict__ Sm, const T* __restrict__ X,
                   const T* __restrict__ s, T* __restrict__ out,
                   T* __restrict__ lsum, T* __restrict__ sbar,
                   T* __restrict__ part, int64_t n, int64_t panel) {
    using S = Sums<PRO, LR>;
    constexpr int NW = kThreads / 32;
    constexpr int LPW = kRT / NW;                // lines a warp
    constexpr int CPL = kCT / 32;                // positions a lane
    constexpr int XPT = kRT * kCT / kThreads;    // X's loads a thread
    extern __shared__ __align__(16) unsigned char k3_dyn[];
    T* acc = reinterpret_cast<T*>(k3_dyn);
    constexpr int NB = S::kCross ? 2 : 1;  // X's buffers
    __shared__ T xt[NB][kRT][kCT + 1];
    __shared__ T cs[NW][kCT];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t nstrips = (n + kRT - 1) / kRT;
    for (int64_t p0 = 0; p0 < n; p0 += panel) {
        const int64_t pend = n - p0 < panel ? n : p0 + panel;
        if (S::kCross) {
            for (int64_t q = tid; q < pend - p0; q += kThreads) acc[q] = T(0);
        }
        int buf = 0;
        for (int64_t st = blockIdx.x; st < nstrips; st += gridDim.x) {
            const int64_t l0 = st * kRT;
            T sl[LPW], lacc[LPW];
#pragma unroll
            for (int r = 0; r < LPW; ++r) {
                const int64_t l = l0 + warp + NW * r;
                sl[r] = l < n ? s[l] : T(1);
                lacc[r] = T(0);
            }
            for (int64_t q0 = p0; q0 < pend; q0 += kCT, buf = (buf + 1) % NB) {
                // X is read only where the chunk meets the lower triangle
                const bool xneed = PRO || (LR ? q0 <= l0 + kRT - 1
                                              : q0 + kCT - 1 >= l0);
                T sv[LPW][CPL], xv[XPT], sq[CPL];
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                    const int64_t q = q0 + lane + 32 * c;
                    sq[c] = q < pend ? s[q] : T(1);
#pragma unroll
                    for (int r = 0; r < LPW; ++r) {
                        const int64_t l = l0 + warp + NW * r;
                        sv[r][c] = l < n && q < pend ? Sm[l * n + q] : T(0);
                    }
                }
#pragma unroll
                for (int u = 0; u < XPT; ++u) {
                    const int idx = u * kThreads + tid;
                    const int64_t q = q0 + idx / kRT, l = l0 + idx % kRT;
                    xv[u] = xneed && q < pend && l < n ? X[q * n + l] : T(0);
                }
                // one buffer: the previous chunk must be done with it
                if (NB == 1) __syncthreads();
#pragma unroll
                for (int u = 0; u < XPT; ++u) {
                    const int idx = u * kThreads + tid;
                    xt[buf][idx % kRT][idx / kRT] = xv[u];
                }
                __syncthreads();  // xt[buf] is in
                T csum[CPL];
#pragma unroll
                for (int c = 0; c < CPL; ++c) {
                    const int64_t q = q0 + lane + 32 * c;
                    csum[c] = T(0);
#pragma unroll
                    for (int r = 0; r < LPW; ++r) {
                        const int64_t l = l0 + warp + NW * r;
                        if (l >= n || q >= pend) continue;
                        const T xvv = xt[buf][warp + NW * r][lane + 32 * c];
                        T o;
                        if (PRO) {  // X = M-bar, S = A
                            o = mul_rn(mul_rn(xvv, sq[c]), sl[r]);
                            const T pr = xvv * sv[r][c];
                            lacc[r] += pr * sq[c];
                            csum[c] += pr * sl[r];
                        } else {    // S = O-bar, X = L
                            const T g = sv[r][c];
                            const T f = lower<PRO, LR>(l, q) ? xvv : T(0);
                            o = g / (LR ? sl[r] : sq[c]);
                            if (LR) lacc[r] += g * f; else csum[c] += g * f;
                        }
                        out[l * n + q] = o;
                    }
                }
                if (S::kCross) {
#pragma unroll
                    for (int c = 0; c < CPL; ++c) {
                        cs[warp][lane + 32 * c] = csum[c];
                    }
                    __syncthreads();
                    if (tid < kCT && q0 + tid < pend) {
                        T t = cs[0][tid];
                        for (int i = 1; i < NW; ++i) t += cs[i][tid];
                        acc[q0 - p0 + tid] += t;
                    }
                }
            }
            if (S::kLine) {
#pragma unroll
                for (int r = 0; r < LPW; ++r) {
                    const int64_t l = l0 + warp + NW * r;
                    const T t = warp_sum(lacc[r]);
                    if (lane != 0 || l >= n) continue;
                    if (PRO) {
                        lsum[l] = p0 == 0 ? t : lsum[l] + t;
                    } else {
                        sbar[l] = -t / (sl[r] * sl[r]);  // one panel
                    }
                }
            }
        }
        __syncthreads();
        if (S::kCross) {
            for (int64_t q = tid; q < pend - p0; q += kThreads) {
                part[blockIdx.x * n + p0 + q] = acc[q];
            }
        }
        __syncthreads();
    }
}

// The cross sums over the CTAs' partials, kFinCols columns a CTA: lane
// ty sums partial rows ty, ty + kFinLanes, ... in order, kFinUnroll
// loads in flight, then one thread the lanes in order. PRO: s-bar =
// sbar_in + line sum + cross sum, and its term added to A-bar's
// diagonal; else the epilogue's s-bar.
template <typename T, bool PRO>
__global__ void __launch_bounds__(kFinCols * kFinLanes)
k3_finish_kernel(const T* __restrict__ part, int nparts,
                 const T* __restrict__ lsum, const T* __restrict__ sbar_in,
                 const T* __restrict__ s, const T* __restrict__ A,
                 T* __restrict__ Abar, T* __restrict__ sbar, int64_t n) {
    __shared__ T red[kFinLanes][kFinCols + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int64_t j = (int64_t)blockIdx.x * kFinCols + tx;
    T acc = T(0);
    if (j < n) {
        for (int b0 = ty; b0 < nparts; b0 += kFinLanes * kFinUnroll) {
            T v[kFinUnroll];
#pragma unroll
            for (int u = 0; u < kFinUnroll; ++u) {
                const int b = b0 + u * kFinLanes;
                v[u] = b < nparts ? part[(int64_t)b * n + j] : T(0);
            }
#pragma unroll
            for (int u = 0; u < kFinUnroll; ++u) acc += v[u];
        }
    }
    red[ty][tx] = acc;
    __syncthreads();
    if (ty != 0 || j >= n) return;
    T c = red[0][tx];
    for (int i = 1; i < kFinLanes; ++i) c += red[i][tx];
    const T sj = s[j];
    if (!PRO) {
        sbar[j] = -c / (sj * sj);
        return;
    }
    const T sb = ((sbar_in != nullptr ? sbar_in[j] : T(0)) + lsum[j]) + c;
    const T a = A[j * (n + 1)];
    if (fabs(a) > tiny<T>()) {
        Abar[j * (n + 1)] += (T(-0.5) * sb * (sj * sj * sj)) * sign_of(a);
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

// CTAs of a backward kernel (kThreads each, smem bytes of dynamic
// shared memory, opted in) resident on the current device at once; with
// out null only the opt-in
template <typename K>
static int resident(K kern, size_t smem, int* out) {
    int dev = 0, nsm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    }
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    if (err == cudaSuccess && out != nullptr) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, smem);
    }
    if (err != cudaSuccess) return (int)err;
    if (out != nullptr) *out = (per_sm > 0 ? per_sm : 1) * nsm;
    return 0;
}

// The line pass at one access width W (see k3_line_bwd_kernel).
template <typename T, bool PRO, bool LR, int W>
static int line_pass(const T* G, const T* F, const T* s, T* out, T* lsum,
                     T* sbar, T* part, int64_t grid, int64_t n,
                     cudaStream_t st, int64_t* used) {
    constexpr int NW = kThreads / 32;
    const auto kern = k3_line_bwd_kernel<T, PRO, LR, W>;
    // the warps' shares of the line sums grow as the grid shrinks to
    // what is resident
    size_t smem = 0;
    for (int round = 0; round < 3; ++round) {
        smem = sizeof(T) * (size_t)(((n + grid - 1) / grid) * NW);
        int cap = 0;
        const int rc = resident(kern, smem, &cap);
        if (rc != 0) return rc;
        if (grid <= cap) break;
        grid = cap;
    }
    smem = sizeof(T) * (size_t)(((n + grid - 1) / grid) * NW);
    const int rc = resident(kern, smem, nullptr);
    if (rc != 0) return rc;
    kern<<<(unsigned)grid, kThreads, smem, st>>>(G, F, s, out, lsum, sbar,
                                                 part, n);
    *used = grid;
    return 0;
}

// One backward: the line pass when G and F are stored alike (same),
// else the tile pass with X the one stored the other way (PRO: M-bar,
// else L), then the finishing pass where there are cross sums. part
// holds maxparts rows of n partials (at most maxparts CTAs take part in
// the cross sums), then the n line sums.
template <typename T, bool PRO, bool LR>
static int bwd_pass(const T* G, const T* F, bool same, const T* s, T* out,
                    T* sbar, const T* sbar_in, const T* A, T* part,
                    int maxparts, int64_t n, cudaStream_t st) {
    using S = Sums<PRO, LR>;
    constexpr int64_t V = 16 / sizeof(T);
    T* lsum = part + (int64_t)maxparts * n;
    int64_t grid = same ? n : (n + kRT - 1) / kRT;
    if (S::kCross && grid > maxparts) grid = maxparts;
    int rc = 0;
    if (same) {
        // every line starts on a multiple of gcd(n, V) elements
        const int64_t w = n % V == 0 ? V : (n % 2 == 0 ? 2 : 1);
        if constexpr (V == 4) {
            if (w == 4) {
                rc = line_pass<T, PRO, LR, 4>(G, F, s, out, lsum, sbar, part,
                                              grid, n, st, &grid);
            }
        }
        if (w == 2) {
            rc = line_pass<T, PRO, LR, 2>(G, F, s, out, lsum, sbar, part,
                                          grid, n, st, &grid);
        } else if (w == 1) {
            rc = line_pass<T, PRO, LR, 1>(G, F, s, out, lsum, sbar, part,
                                          grid, n, st, &grid);
        }
    } else {
        const int64_t cap = kPanelBytes / (int64_t)sizeof(T);
        const int64_t panel = S::kCross && n > cap ? cap : n;
        const size_t smem = S::kCross ? sizeof(T) * (size_t)panel : 0;
        const auto tile = k3_tile_bwd_kernel<T, PRO, LR>;
        int cap_ctas = 0;
        rc = resident(tile, smem, &cap_ctas);
        if (rc == 0) {
            if (grid > cap_ctas) grid = cap_ctas;
            tile<<<(unsigned)grid, kThreads, smem, st>>>(
                PRO ? F : G, PRO ? G : F, s, out, lsum, sbar, part, n, panel);
        }
    }
    if (rc != 0) return rc;
    if (S::kCross) {
        k3_finish_kernel<T, PRO><<<(unsigned)((n + kFinCols - 1) / kFinCols),
                                   dim3(kFinCols, kFinLanes), 0, st>>>(
            part, (int)grid, lsum, sbar_in, s, A, out, sbar, n);
    }
    return (int)cudaGetLastError();
}

template <typename T>
static int descale_bwd(const T* Obar, int ocol, const T* L, int lcol,
                       const T* s, T* Lbar, T* sbar, T* part, int maxparts,
                       int64_t n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const bool same = ocol == lcol;
    // lines are O-bar's: rows (s-bar a line sum) or columns (a cross sum)
    return ocol ? bwd_pass<T, false, false>(Obar, L, same, s, Lbar, sbar,
                                            nullptr, nullptr, part,
                                            maxparts, n, st)
                : bwd_pass<T, false, true>(Obar, L, same, s, Lbar, sbar,
                                           nullptr, nullptr, part, maxparts,
                                           n, st);
}

template <typename T>
static int prologue_bwd(const T* Mbar, int mcol, const T* A, const T* s,
                        const T* sbar_in, T* Abar, T* part, int maxparts,
                        int64_t n, int equil, double scale, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (!equil) {
        // part[0]: g
        k3_trace_kernel<T><<<1, kPrepass, 0, st>>>(Mbar, A, part, n, scale);
        k3_add_diag_kernel<T><<<rows_grid(n), kThreads, 0, st>>>(Mbar, part,
                                                              Abar, n);
        return (int)cudaGetLastError();
    }
    // A and A-bar are row-major: lines are rows
    return bwd_pass<T, true, true>(Mbar, A, mcol == 0, s, Abar, nullptr,
                                   sbar_in, A, part, maxparts, n, st);
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
                                        T* sbar, T* part, int maxparts,       \
                                        int64_t n, void* stream) {            \
        return descale_bwd<T>(Obar, ocol, L, lcol, s, Lbar, sbar, part,       \
                              maxparts, n, stream);                           \
    }                                                                         \
    extern "C" int k3_prologue_bwd_##SFX(const T* Mbar, int mcol, const T* A, \
                                         const T* s, const T* sbar_in,        \
                                         T* Abar, T* part, int maxparts,      \
                                         int64_t n, int equil, double scale,  \
                                         void* stream) {                      \
        return prologue_bwd<T>(Mbar, mcol, A, s, sbar_in, Abar, part,         \
                               maxparts, n, equil, scale, stream);            \
    }

K3_ENTRIES(float, f32)
K3_ENTRIES(double, f64)
