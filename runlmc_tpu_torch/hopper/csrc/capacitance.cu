// K2: the Woodbury capacitance matrix of the dense-grid SKI covariance,
// and its backward.
//
//   C = I + sum_d eps_d^-1 F_d^T G_d F_d        (one group)
//   C_ab = sum_d eps_d^-1 F_{a,d}^T G_{ab,d} F_{b,d},  C_ba = C_ab^T
//
// F_g is the lower Cholesky factor of group g's K_UU (k_g = D m_g rows),
// F_{g,d} its rows d m_g .. (d+1) m_g - 1, and G_{ab,d} = W_{a,d}^T W_{b,d}
// the gram of output d's interpolation blocks (G_{aa,d} = W^T W, banded:
// |i - j| <= 3 on a 1-D grid, block-banded on a 2-D one). Replaces
// runlmc_tpu/lmc/woodbury.py:260-298 (build_device_woodbury's diag_block
// and cross_block: a batched gram product and one (Dm, Dm) x (Dm, Dm)
// einsum, which XLA runs dense).
//
// Three structural facts make the dense product mostly zeros, and this
// kernel skips them: F_{g,d} is zero past column (d+1) m_g (F is lower
// triangular), G_{ab,d} is zero outside a few tiles per row block (the
// host lists the nonzero tiles once per grid), and C is symmetric. The
// operation count falls from 2 D m^2 Dm + 2 Dm^3 to about m^3 sum_d d^2
// (5.3x fewer at the weather twin's D = 4, m = 2504), which bounds it on
// the card: operations, not bytes.
//
// Stage 1 (gram_apply): T_{ab,d} = G_{ab,d} F_{b,d}, a 64 x 64 output
//   tile per CTA, its k-loop over the nonzero 64 x 16 tiles of G_{ab,d}
//   in the host plan, zero column tiles of F skipped.
// Stage 2 (cap): one CTA per lower output tile of C; it loops over the d
//   whose F_{a,d} reaches that tile, in a fixed order, and over the rows
//   i of F_{a,d} that are nonzero there, with eps_d^-1 folded into the
//   load of F; it adds I and mirrors the tile into the upper triangle.
// Backward (cap_bwd): with S = Cbar + Cbar^T (formed in the load),
//   Y_{a,d} = T_{a.,d} S[:, a],  Fbar_{a,d} = eps_d^-1 Y_{a,d} on F's lower
//   triangle (0 above: a Cholesky backward reads only the lower one), and
//   per-tile partial sums of <F_{a,d}, Y_{a,d}>; eps_reduce adds them in a
//   fixed order into d(eps_d^-1) = 1/2 sum_a <F_{a,d}, Y_{a,d}>.
//
// Every output element is one thread's own sum in a fixed order: no
// atomics, no split-K, the same bits on every run. SIMT FMA (TF32 stays
// off; FFMA for float, DFMA for double); each CTA stages 8-deep slices of
// its two operands through shared memory, and each thread keeps a TM x TM
// register tile, which stage 2 and the backward add into running totals
// in shared memory every 128 terms (kFlush). F may be stored row- or
// column-major (cuSOLVER leaves the latter): the loaders take both,
// through strides. Entries of F above its diagonal are read as zeros, so
// the result is a function of tril(F).

#include "common.cuh"

namespace {

constexpr int kBK = 8;      // depth of one shared-memory slice
constexpr int kPlanRows = 64;  // rows of a plan tile of G (stage-1 BM)
constexpr int kPlanCols = 16;  // columns of a plan tile of G
// Slices a thread's register tile sums before it adds them to the CTA's
// running totals, which stage 2 and the backward keep in shared memory
// (each thread its own entries, so no barrier): a sum of n float32 terms
// in one register rounds like n terms, in blocks of 128 like
// n / 128 + 128. The weather twin's entries sum up to 10016 terms, and
// the float32 preconditioner's PCG iterations follow C's rounding. The
// totals live in shared memory, not in a second register tile, which
// would halve the CTAs per SM.
constexpr int kFlush = 16;

// acc[i][j] += sum_{r in [r0, r1)} X(r, p0 + ty + i S) Y(r, q0 + tx + j S)
// with S = BM / TM, calling ``flush(acc)`` after every kFlush slices.
// ``lx(r, c)`` / ``ly(r, c)`` return the operand at row r and tile column
// c (0 where out of range); ``x_rows_fast`` says the X operand is
// contiguous along r (so consecutive threads load consecutive r),
// likewise ``y_rows_fast``.
template <typename T, int BM, int TM, class LX, class LY, class FL>
__device__ __forceinline__ void accumulate(T (&acc)[TM][TM],
                                           T (*sx)[BM + 1], T (*sy)[BM + 1],
                                           int r0, int r1, bool x_rows_fast,
                                           bool y_rows_fast, LX lx, LY ly,
                                           FL flush) {
    constexpr int S = BM / TM;
    constexpr int NT = S * S;
    const int tid = threadIdx.x;
    const int tx = tid % S, ty = tid / S;
    int slices = 0;
    for (int rb = r0; rb < r1; rb += kBK) {
        __syncthreads();
        for (int e = tid; e < kBK * BM; e += NT) {
            const int rr = x_rows_fast ? e % kBK : e / BM;
            const int cc = x_rows_fast ? e / kBK : e % BM;
            sx[rr][cc] = rb + rr < r1 ? lx(rb + rr, cc) : T(0);
        }
        for (int e = tid; e < kBK * BM; e += NT) {
            const int rr = y_rows_fast ? e % kBK : e / BM;
            const int cc = y_rows_fast ? e / kBK : e % BM;
            sy[rr][cc] = rb + rr < r1 ? ly(rb + rr, cc) : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
            T a[TM], b[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = sx[k][ty + i * S];
#pragma unroll
            for (int j = 0; j < TM; ++j) b[j] = sy[k][tx + j * S];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TM; ++j) acc[i][j] += a[i] * b[j];
        }
        if (++slices == kFlush) {
            flush(acc);
            slices = 0;
        }
    }
}

// The running totals of stage 2 and the backward: dynamic shared memory,
// BM x (BM + 1) of T per CTA.
template <typename T, int BM, int TM>
struct Totals {
    static constexpr int S = BM / TM;
    static constexpr size_t bytes = sizeof(T) * BM * (BM + 1);
    T (*tot)[BM + 1];
    int tx, ty;
    __device__ Totals() : tx(threadIdx.x % S), ty(threadIdx.x / S) {
        extern __shared__ __align__(16) unsigned char k2_totals[];
        tot = reinterpret_cast<T (*)[BM + 1]>(k2_totals);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) tot[ty + i * S][tx + j * S] = T(0);
    }
    __device__ void operator()(T (&acc)[TM][TM]) const {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) {
                tot[ty + i * S][tx + j * S] += acc[i][j];
                acc[i][j] = T(0);
            }
    }
    __device__ T operator()(int i, int j) const {
        return tot[ty + i * S][tx + j * S];
    }
};

// Stage 1: Tout[(d ma + p) ldt + qoff + q] = sum_r G[d][p][r] F_b[d mb + r][q]
// for p < ma, q < kb; grid (ceil(kb/64), ceil(ma/64), D).
template <typename T>
__global__ void __launch_bounds__(256)
gram_apply_kernel(const T* __restrict__ G, int ma, int mb,
                  const T* __restrict__ F, int64_t fsr, int64_t fsc, int kb,
                  const int* __restrict__ ptr, const int* __restrict__ rblk,
                  T* __restrict__ Tout, int64_t ldt, int qoff) {
    constexpr int BM = kPlanRows, TM = 4, S = BM / TM;
    __shared__ T sx[kBK][BM + 1];
    __shared__ T sy[kBK][BM + 1];
    const int q0 = blockIdx.x * BM, p0 = blockIdx.y * BM, d = blockIdx.z;
    const int npb = gridDim.y;
    T acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = T(0);
    // F_{b,d}[r][q] is nonzero only for q <= d mb + r
    if (q0 < (d + 1) * mb) {
        const int rmin = q0 - d * mb > 0 ? q0 - d * mb : 0;
        const T* Gd = G + (int64_t)d * ma * mb;
        const T* Fd = F + (int64_t)d * mb * fsr;
        const int dmb = d * mb;
        auto lx = [=](int r, int c) -> T {
            const int p = p0 + c;
            return p < ma ? Gd[(int64_t)p * mb + r] : T(0);
        };
        auto ly = [=](int r, int c) -> T {
            const int q = q0 + c;
            return (q < kb && q <= dmb + r) ? Fd[r * fsr + q * fsc] : T(0);
        };
        const int lo = ptr[d * npb + blockIdx.y];
        const int hi = ptr[d * npb + blockIdx.y + 1];
        for (int e = lo; e < hi; ++e) {
            int rs = rblk[e] * kPlanCols;
            const int re = rs + kPlanCols < mb ? rs + kPlanCols : mb;
            rs = rs > rmin ? rs : rmin;
            if (rs >= re) continue;
            accumulate<T, BM, TM>(acc, sx, sy, rs, re, true, fsr == 1, lx,
                                  ly, [](T (&)[TM][TM]) {});
        }
    }
    const int tx = threadIdx.x % S, ty = threadIdx.x / S;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int p = p0 + ty + i * S;
        if (p >= ma) continue;
        T* row = Tout + ((int64_t)d * ma + p) * ldt + qoff;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
            const int q = q0 + tx + j * S;
            if (q < kb) row[q] = acc[i][j];
        }
    }
}

// The lower tiles of an n x n tile triangle, by linear index.
__device__ __forceinline__ void lower_tile(int t, int& tk, int& tl) {
    int k = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    while ((k + 1) * (k + 2) / 2 <= t) ++k;
    while (k * (k + 1) / 2 > t) --k;
    tk = k;
    tl = t - k * (k + 1) / 2;
}

// Stage 2: block (a, b) of C, rows offa + k (k < ka), columns offb + l
// (l < kb): sum_d inv_eps[d] sum_i F_a[d ma + i][k] Ta[d][i][offb + l],
// plus 1 on the diagonal, written with its mirror. ``diag``: a == b,
// lower tiles only (tk >= tl) and, on a diagonal tile, k >= l only.
template <typename T, int BM, int TM>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
cap_kernel(const T* __restrict__ Fa, int64_t fsr, int64_t fsc, int ka,
           int ma, int D, const T* __restrict__ Ta, int64_t ldt, int offb,
           int kb, const T* __restrict__ inv_eps, T* __restrict__ C,
           int64_t ldc, int offa, int diag) {
    constexpr int S = BM / TM;
    __shared__ T sx[kBK][BM + 1];
    __shared__ T sy[kBK][BM + 1];
    int tk, tl;
    if (diag) {
        lower_tile(blockIdx.x, tk, tl);
    } else {
        const int ntl = (kb + BM - 1) / BM;
        tk = blockIdx.x / ntl;
        tl = blockIdx.x % ntl;
    }
    const int k0 = tk * BM, l0 = tl * BM;
    T acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = T(0);
    const Totals<T, BM, TM> tot;
    // F_{a,d}[i][k] is nonzero only for k <= d ma + i: the tile's first
    // column k0 needs d >= k0 / ma and i >= k0 - d ma
    for (int d = k0 / ma; d < D; ++d) {
        const int imin = k0 - d * ma > 0 ? k0 - d * ma : 0;
        const T s = inv_eps[d];
        const T* Fd = Fa + (int64_t)d * ma * fsr;
        const T* Td = Ta + (int64_t)d * ma * ldt + offb;
        const int dma = d * ma;
        auto lx = [=](int i, int c) -> T {
            const int k = k0 + c;
            return (k < ka && k <= dma + i) ? s * Fd[i * fsr + k * fsc]
                                            : T(0);
        };
        auto ly = [=](int i, int c) -> T {
            const int l = l0 + c;
            return l < kb ? Td[i * ldt + l] : T(0);
        };
        accumulate<T, BM, TM>(acc, sx, sy, imin, ma, fsr == 1, false, lx,
                              ly, tot);
    }
    tot(acc);
    const int tx = threadIdx.x % S, ty = threadIdx.x / S;
    const bool on_diag = diag && tk == tl;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int k = k0 + ty + i * S;
        if (k >= ka) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
            const int l = l0 + tx + j * S;
            if (l >= kb || (on_diag && l > k)) continue;
            const int64_t K = offa + k, L = offb + l;
            T v = tot(i, j);
            if (K == L) v += T(1);
            C[K * ldc + L] = v;
            C[L * ldc + K] = v;
        }
    }
}

struct Groups {
    static constexpr int kMax = 8;
    int n;
    int off[kMax], k[kMax], m[kMax];
};

// Backward of group a: Fbar_a[d ma + i][c] = inv_eps[d] Y, with
// Y = sum_r Ta[d][i][r] (Cbar[r][offa + c] + Cbar[offa + c][r]) on F_a's
// lower triangle (c <= d ma + i), 0 above; ``partial`` gets each tile's
// sum of F_a * Y, ``pstride`` apart per d. Grid (ceil(ka/BM), ceil(ma/BM),
// D).
template <typename T, int BM, int TM>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
cap_bwd_kernel(const T* __restrict__ Fa, int64_t fsr, int64_t fsc, int ka,
               int ma, const T* __restrict__ Ta, int64_t ldt,
               const T* __restrict__ Cbar, int64_t ldc, int offa, Groups gr,
               const T* __restrict__ inv_eps, T* __restrict__ Fbar,
               T* __restrict__ partial, int64_t pstride) {
    constexpr int S = BM / TM, NT = S * S;
    __shared__ T sx[kBK][BM + 1];
    __shared__ T sy[kBK][BM + 1];
    __shared__ T red[NT];
    const int q0 = blockIdx.x * BM, p0 = blockIdx.y * BM, d = blockIdx.z;
    const int dma = d * ma;
    const int plast = (p0 + BM < ma ? p0 + BM : ma) - 1;
    T acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = T(0);
    const Totals<T, BM, TM> tot;
    if (q0 <= dma + plast) {  // else the whole tile lies above F's diagonal
        const T* Td = Ta + ((int64_t)dma + p0) * ldt;
        const T* Cq = Cbar + offa + q0;           // Cbar[r][offa + q0 + c]
        const T* Ct = Cbar + (int64_t)(offa + q0) * ldc;  // Cbar[offa+q0+c][r]
        auto lx = [=](int r, int c) -> T {
            return p0 + c < ma ? Td[(int64_t)c * ldt + r] : T(0);
        };
        auto ly = [=](int r, int c) -> T {
            return q0 + c < ka ? Cq[(int64_t)r * ldc + c] +
                                     Ct[(int64_t)c * ldc + r]
                               : T(0);
        };
        // T_{a b, d} is zero past column (d + 1) m_b of each group b
        for (int g = 0; g < gr.n; ++g) {
            const int width = (d + 1) * gr.m[g] < gr.k[g] ? (d + 1) * gr.m[g]
                                                          : gr.k[g];
            accumulate<T, BM, TM>(acc, sx, sy, gr.off[g], gr.off[g] + width,
                                  true, false, lx, ly, tot);
        }
    }
    tot(acc);
    const int tx = threadIdx.x % S, ty = threadIdx.x / S;
    const T s = inv_eps[d];
    T part = T(0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int p = p0 + ty + i * S;
        if (p >= ma) continue;
        const int64_t row = (int64_t)dma + p;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
            const int c = q0 + tx + j * S;
            if (c >= ka) continue;
            const T y = c <= row ? tot(i, j) : T(0);
            Fbar[row * ka + c] = s * y;
            part += Fa[row * fsr + c * fsc] * y;
        }
    }
    red[threadIdx.x] = part;
    __syncthreads();
    for (int w = NT / 2; w > 0; w >>= 1) {
        if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        partial[d * pstride + (int64_t)blockIdx.y * gridDim.x +
                blockIdx.x] = red[0];
    }
}

// out[d] = 1/2 sum_a sum_t partial[a][d][t], t < ntiles, in a fixed
// order; one CTA per d.
template <typename T>
__global__ void eps_reduce_kernel(const T* __restrict__ partial, int ngroups,
                                  int D, int ntiles, T* __restrict__ out) {
    __shared__ T red[256];
    const int d = blockIdx.x;
    T s = T(0);
    for (int a = 0; a < ngroups; ++a) {
        const T* p = partial + ((int64_t)a * D + d) * ntiles;
        for (int t = threadIdx.x; t < ntiles; t += blockDim.x) s += p[t];
    }
    red[threadIdx.x] = s;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[d] = T(0.5) * red[0];
}

// Tile sizes of stage 2 and the backward: 128 x 128 output tiles of 8 x 8
// per thread in float, 64 x 64 of 4 x 4 in double (the register tile of
// doubles costs twice the registers).
template <typename T> struct Cfg;
template <> struct Cfg<float> { static constexpr int BM = 128, TM = 8; };
template <> struct Cfg<double> { static constexpr int BM = 64, TM = 4; };

template <typename T>
int gram_apply(const T* G, int D, int ma, int mb, const T* F, int64_t fsr,
               int64_t fsc, int kb, const int* ptr, const int* rblk,
               T* Tout, int64_t ldt, int qoff, int plan_rows, int plan_cols,
               void* stream) {
    if (plan_rows != kPlanRows || plan_cols != kPlanCols) return -1;
    dim3 grid((unsigned)((kb + kPlanRows - 1) / kPlanRows),
              (unsigned)((ma + kPlanRows - 1) / kPlanRows), (unsigned)D);
    gram_apply_kernel<T><<<grid, 256, 0, (cudaStream_t)stream>>>(
        G, ma, mb, F, fsr, fsc, kb, ptr, rblk, Tout, ldt, qoff);
    return (int)cudaGetLastError();
}

template <typename T>
int cap(const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,
        const T* Ta, int64_t ldt, int offb, int kb, const T* inv_eps, T* C,
        int64_t ldc, int offa, int diag, void* stream) {
    constexpr int BM = Cfg<T>::BM, TM = Cfg<T>::TM;
    const int64_t nk = (ka + BM - 1) / BM, nl = (kb + BM - 1) / BM;
    const int64_t tiles = diag ? nk * (nk + 1) / 2 : nk * nl;
    constexpr size_t smem = Totals<T, BM, TM>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        cap_kernel<T, BM, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    cap_kernel<T, BM, TM><<<(unsigned)tiles, (BM / TM) * (BM / TM), smem,
                            (cudaStream_t)stream>>>(
        Fa, fsr, fsc, ka, ma, D, Ta, ldt, offb, kb, inv_eps, C, ldc, offa,
        diag);
    return (int)cudaGetLastError();
}

template <typename T>
int cap_bwd(const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,
            const T* Ta, int64_t ldt, const T* Cbar, int64_t ldc, int offa,
            int ngroups, const int* goff, const int* gk, const int* gm,
            const T* inv_eps, T* Fbar, T* partial, int64_t pstride,
            void* stream) {
    constexpr int BM = Cfg<T>::BM, TM = Cfg<T>::TM;
    if (ngroups > Groups::kMax) return -1;
    Groups gr;
    gr.n = ngroups;
    for (int g = 0; g < ngroups; ++g) {
        gr.off[g] = goff[g];
        gr.k[g] = gk[g];
        gr.m[g] = gm[g];
    }
    dim3 grid((unsigned)((ka + BM - 1) / BM), (unsigned)((ma + BM - 1) / BM),
              (unsigned)D);
    constexpr size_t smem = Totals<T, BM, TM>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        cap_bwd_kernel<T, BM, TM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cap_bwd_kernel<T, BM, TM><<<grid, (BM / TM) * (BM / TM), smem,
                                (cudaStream_t)stream>>>(
        Fa, fsr, fsc, ka, ma, Ta, ldt, Cbar, ldc, offa, gr, inv_eps, Fbar,
        partial, pstride);
    return (int)cudaGetLastError();
}

template <typename T>
int eps_reduce(const T* partial, int ngroups, int D, int ntiles, T* out,
               void* stream) {
    eps_reduce_kernel<T><<<(unsigned)D, 256, 0, (cudaStream_t)stream>>>(
        partial, ngroups, D, ntiles, out);
    return (int)cudaGetLastError();
}

}  // namespace

// Tile sizes the wrapper needs to size its scratch.
extern "C" int k2_bwd_tile(int is_f64) {
    return is_f64 ? Cfg<double>::BM : Cfg<float>::BM;
}

#define K2_ENTRIES(T, SFX)                                                    \
    extern "C" int k2_gram_apply_##SFX(                                      \
        const T* G, int D, int ma, int mb, const T* F, int64_t fsr,           \
        int64_t fsc, int kb, const int* ptr, const int* rblk, T* Tout,        \
        int64_t ldt, int qoff, int plan_rows, int plan_cols, void* stream) {  \
        return gram_apply<T>(G, D, ma, mb, F, fsr, fsc, kb, ptr, rblk, Tout,  \
                             ldt, qoff, plan_rows, plan_cols, stream);        \
    }                                                                         \
    extern "C" int k2_cap_##SFX(const T* Fa, int64_t fsr, int64_t fsc,        \
                                int ka, int ma, int D, const T* Ta,           \
                                int64_t ldt, int offb, int kb,                \
                                const T* inv_eps, T* C, int64_t ldc,          \
                                int offa, int diag, void* stream) {           \
        return cap<T>(Fa, fsr, fsc, ka, ma, D, Ta, ldt, offb, kb, inv_eps, C, \
                      ldc, offa, diag, stream);                               \
    }                                                                         \
    extern "C" int k2_cap_bwd_##SFX(                                         \
        const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,         \
        const T* Ta, int64_t ldt, const T* Cbar, int64_t ldc, int offa,       \
        int ngroups, const int* goff, const int* gk, const int* gm,           \
        const T* inv_eps, T* Fbar, T* partial, int64_t pstride,               \
        void* stream) {                                                       \
        return cap_bwd<T>(Fa, fsr, fsc, ka, ma, D, Ta, ldt, Cbar, ldc, offa,  \
                          ngroups, goff, gk, gm, inv_eps, Fbar, partial,      \
                          pstride, stream);                                   \
    }                                                                         \
    extern "C" int k2_eps_reduce_##SFX(const T* partial, int ngroups, int D,  \
                                       int ntiles, T* out, void* stream) {    \
        return eps_reduce<T>(partial, ngroups, D, ntiles, out, stream);       \
    }

K2_ENTRIES(float, f32)
K2_ENTRIES(double, f64)
