// K5: triangular solves with a lower Cholesky factor L (k, k),
//
//   X[j, :] = L^-1 B[j, :]      (forward substitution), or
//   X[j, :] = L^-T B[j, :]      (backward substitution, trans=1),
//
// for the c right-hand sides held as the rows of B (c, k), row-major, the
// way the callers hold them. L is read row-major or column-major (the
// latter is how cuSOLVER's Cholesky leaves it); its upper triangle is
// never used. Sums run in the dtype of L, as the JAX package's
// solve_triangular does at HIGHEST precision.
//
// Replaces the XLA code at runlmc_tpu/lmc/woodbury.py:186-195
// (DeviceWoodbury._cho_solve_C: jax.scipy.linalg.cho_solve) and :313-337
// (kinv_diag: solve_triangular), which XLA expands into blocked matmuls.
//
// Bound on the card: reading the triangle, k^2/2 elements (each right-hand
// side read and each solution written once besides), or k^2 c operations
// at the FP32/FP64 peak for wide c. Substitution itself is a chain of k
// dependent steps, so for narrow c the chain's latency, not the bytes,
// sets the time.
//
// Design: one launch per triangle. L is cut into row blocks of kNB = 64;
// one CTA owns one block of rows and a tile of CT right-hand sides. It
// takes its block from an atomic ticket (not blockIdx), so it only ever
// waits on CTAs that started before it: a CTA of block i adds up
// L_ij X_j for the blocks j before it (after it, for trans) in the order
// they are published (each tile's 64 terms summed apart, so the rounding
// grows with the number of tiles, not with k), prefetching each L tile
// into registers before it waits on that block's flag. It then solves its
// 64 x 64 diagonal block (loaded, with its reciprocal pivots, before the
// first wait) by substitution (a warp per right-hand side, a lane per two
// rows, the next step's operands read ahead of the shuffles), writes
// X_i, fences and publishes a per-(block, tile) flag with a release store.
// Readers take the flag with an acquire load and read X_j through L2
// (__ldcg). The flags and the ticket are zeroed by a cudaMemsetAsync on
// the launch's stream, so no state outlives a launch. Nothing waits on
// data, so a NaN in L comes back as NaN in X and never stalls a CTA.
// Every sum runs in a fixed order: a second launch is bit-identical.

#include "common.cuh"

namespace {

constexpr int kNB = 64;          // rows of a block
constexpr int kThreads = 256;
constexpr int kLds = kNB + 1;    // padded row of a shared L tile
constexpr int kTileElems = kNB * kNB / kThreads;  // L tile per thread
// A CTA that polls a flag this often (seconds) traps: a launch error, not
// a hung card, should the ordering ever break.
constexpr int kMaxPolls = 1 << 26;

__device__ __forceinline__ int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// One element of the tile (r0 + a, c0 + b) of L, zero outside the matrix;
// the thread's element e of a tile, chosen so that neighbouring threads
// read neighbouring addresses in either storage order.
template <bool LCOL>
__device__ __forceinline__ void tile_coords(int tid, int e, int* a, int* b) {
    if (LCOL) {
        *a = tid % kNB;
        *b = tid / kNB + e * (kThreads / kNB);
    } else {
        *a = tid / kNB + e * (kThreads / kNB);
        *b = tid % kNB;
    }
}

template <typename T, bool LCOL>
__device__ __forceinline__ T load_l(const T* L, int k, int r, int c) {
    return LCOL ? L[(int64_t)c * k + r] : L[(int64_t)r * k + c];
}

// CT right-hand sides per CTA; each thread keeps an RM x RN tile of the
// block's running sums (rows ty + i*TY, columns tx + j*TX).
template <typename T, int CT, int RN, bool TRANS, bool LCOL>
__global__ void __launch_bounds__(kThreads)
k5_trsm_lower(const T* __restrict__ L, const T* __restrict__ B, T* X,
              int* flags, int k, int c, int nblocks, int ntiles) {
    constexpr int TX = CT / RN;
    constexpr int TY = kThreads / TX;
    constexpr int RM = kNB / TY;
    constexpr int kXs = CT + 1;
    constexpr int CW = CT / (kThreads / 32);  // right-hand sides per warp
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ld = reinterpret_cast<T*>(smem_raw);  // kNB x kLds, diagonal block
    T* Lt = Ld + kNB * kLds;                 // kNB x kLds, coupling tile
    T* Xs = Lt + kNB * kLds;                 // kNB x kXs
    __shared__ T s_inv[kNB];
    __shared__ int s_ticket;

    const int tid = threadIdx.x;
    if (tid == 0) s_ticket = atomicAdd(&flags[nblocks * ntiles], 1);
    __syncthreads();
    const int ticket = s_ticket;
    const int tile = ticket % ntiles;
    const int step = ticket / ntiles;
    const int bi = TRANS ? nblocks - 1 - step : step;
    const int row0 = bi * kNB;
    const int nrows = min(kNB, k - row0);
    const int col0 = tile * CT;
    const int ncols = min(CT, c - col0);
    const int tx = tid % TX, ty = tid / TX;

    // the diagonal block and its reciprocal pivots first: they depend on
    // nothing, so they leave the chain of waits
#pragma unroll
    for (int e = 0; e < kTileElems; ++e) {
        int a, b;
        tile_coords<LCOL>(tid, e, &a, &b);
        Ld[a * kLds + b] = (a < nrows && b < nrows)
                               ? load_l<T, LCOL>(L, k, row0 + a, row0 + b)
                               : T(0);
    }
    __syncthreads();
    if (tid < kNB)
        s_inv[tid] = tid < nrows ? T(1) / Ld[tid * kLds + tid] : T(0);

    T acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int r = ty + i * TY, cn = tx + j * TX;
            acc[i][j] = (r < nrows && cn < ncols)
                            ? B[(int64_t)(col0 + cn) * k + row0 + r]
                            : T(0);
        }
    }

    // the blocks solved before this one, in the order they are published
    for (int s = 0; s < step; ++s) {
        const int bj = TRANS ? nblocks - 1 - s : s;
        // the tile of L that couples block bj into block bi: rows of bi and
        // columns of bj, or (trans) rows of bj and columns of bi
        const int tr0 = TRANS ? bj * kNB : row0;
        const int tc0 = TRANS ? row0 : bj * kNB;
        const int tnr = min(kNB, k - tr0), tnc = min(kNB, k - tc0);
        const int jrows = min(kNB, k - bj * kNB);
        T lreg[kTileElems];
#pragma unroll
        for (int e = 0; e < kTileElems; ++e) {
            int a, b;
            tile_coords<LCOL>(tid, e, &a, &b);
            lreg[e] = (a < tnr && b < tnc)
                          ? load_l<T, LCOL>(L, k, tr0 + a, tc0 + b) : T(0);
        }
        if (tid == 0) {
            const int* f = flags + bj * ntiles + tile;
            for (int polls = 0; load_acquire(f) == 0; ++polls) {
                if (polls == kMaxPolls) __trap();
            }
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kTileElems; ++e) {
            int a, b;
            tile_coords<LCOL>(tid, e, &a, &b);
            Lt[a * kLds + b] = lreg[e];
        }
        for (int e = tid; e < kNB * CT; e += kThreads) {
            const int p = e % kNB, cn = e / kNB;
            Xs[p * kXs + cn] =
                (p < jrows && cn < ncols)
                    ? __ldcg(X + (int64_t)(col0 + cn) * k + bj * kNB + p)
                    : T(0);
        }
        __syncthreads();
        // the tile's 64 terms summed apart, then taken from the running
        // sum: the rounding grows with the tiles, not with k
        T part[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
            for (int j = 0; j < RN; ++j) part[i][j] = T(0);
        }
#pragma unroll 4
        for (int p = 0; p < kNB; ++p) {
            T xv[RN], lv[RM];
#pragma unroll
            for (int j = 0; j < RN; ++j) xv[j] = Xs[p * kXs + tx + j * TX];
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const int r = ty + i * TY;
                lv[i] = TRANS ? Lt[p * kLds + r] : Lt[r * kLds + p];
            }
#pragma unroll
            for (int i = 0; i < RM; ++i) {
#pragma unroll
                for (int j = 0; j < RN; ++j) part[i][j] += lv[i] * xv[j];
            }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] -= part[i][j];
        }
        __syncthreads();
    }

    // the running sums into Xs
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j)
            Xs[(ty + i * TY) * kXs + tx + j * TX] = acc[i][j];
    }
    __syncthreads();

    // substitution: warp w solves right-hand sides w, w + 8, ...; lane l
    // holds rows l and l + 32 of each
    const int warp = tid / 32, lane = tid % 32;
    if (warp < ncols) {
        T v0[CW], v1[CW];
#pragma unroll
        for (int q = 0; q < CW; ++q) {
            const int cn = warp + q * (kThreads / 32);
            v0[q] = Xs[lane * kXs + cn];
            v1[q] = Xs[(lane + 32) * kXs + cn];
        }
        // step r: x_r = v_r / L_rr, broadcast by a shuffle, then taken
        // from the rows below (above, for trans); the next step's pivot and
        // column of L are read ahead, off the chain of shuffles
        constexpr int dr = TRANS ? -1 : 1;
        int r = TRANS ? nrows - 1 : 0;
        T inv = s_inv[r];
        T l0 = TRANS ? Ld[r * kLds + lane] : Ld[lane * kLds + r];
        T l1 = TRANS ? Ld[r * kLds + lane + 32] : Ld[(lane + 32) * kLds + r];
        for (int step_r = 0; step_r < nrows; ++step_r, r += dr) {
            const int rn = min(max(r + dr, 0), kNB - 1);
            const T ninv = s_inv[rn];
            const T nl0 = TRANS ? Ld[rn * kLds + lane] : Ld[lane * kLds + rn];
            const T nl1 = TRANS ? Ld[rn * kLds + lane + 32]
                                : Ld[(lane + 32) * kLds + rn];
            const bool upd0 = TRANS ? lane < r : lane > r;
            const bool upd1 = TRANS ? lane + 32 < r : lane + 32 > r;
#pragma unroll
            for (int q = 0; q < CW; ++q) {
                const T x = __shfl_sync(0xffffffffu, r < 32 ? v0[q] : v1[q],
                                        r & 31) * inv;
                if (upd0) v0[q] -= l0 * x;
                else if (lane == r) v0[q] = x;
                if (upd1) v1[q] -= l1 * x;
                else if (lane + 32 == r) v1[q] = x;
            }
            inv = ninv;
            l0 = nl0;
            l1 = nl1;
        }
#pragma unroll
        for (int q = 0; q < CW; ++q) {
            const int cn = warp + q * (kThreads / 32);
            if (cn < ncols) {
                T* xo = X + (int64_t)(col0 + cn) * k + row0;
                if (lane < nrows) xo[lane] = v0[q];
                if (lane + 32 < nrows) xo[lane + 32] = v1[q];
            }
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flags + bi * ntiles + tile, 1);
}

template <typename T, int CT, int RN, bool TRANS, bool LCOL>
int launch_tile(const T* L, const T* B, T* X, int* flags, int k, int c,
                cudaStream_t stream) {
    const int nblocks = (k + kNB - 1) / kNB;
    const int ntiles = (c + CT - 1) / CT;
    const size_t smem = sizeof(T) * (size_t)kNB * (2 * kLds + CT + 1);
    auto kern = k5_trsm_lower<T, CT, RN, TRANS, LCOL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(flags, 0,
                          sizeof(int) * ((size_t)nblocks * ntiles + 1),
                          stream);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)(nblocks * ntiles), kThreads, smem, stream>>>(
        L, B, X, flags, k, c, nblocks, ntiles);
    return (int)cudaGetLastError();
}

// Narrow c (one right-hand side in training, 16 in the stochastic
// preconditioner) takes tiles of 16; wide c tiles of 64.
template <typename T, bool TRANS, bool LCOL>
int launch_ct(const T* L, const T* B, T* X, int* flags, int k, int c,
              cudaStream_t stream) {
    if (c <= 16)
        return launch_tile<T, 16, 2, TRANS, LCOL>(L, B, X, flags, k, c,
                                                  stream);
    return launch_tile<T, 64, 4, TRANS, LCOL>(L, B, X, flags, k, c, stream);
}

template <typename T>
int launch(const T* L, const T* B, T* X, int* flags, int k, int c,
           int trans, int lcol, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (trans)
        return lcol ? launch_ct<T, true, true>(L, B, X, flags, k, c, st)
                    : launch_ct<T, true, false>(L, B, X, flags, k, c, st);
    return lcol ? launch_ct<T, false, true>(L, B, X, flags, k, c, st)
                : launch_ct<T, false, false>(L, B, X, flags, k, c, st);
}

}  // namespace

// flags: at least ceil(k / 64) * ceil(c / 16) + 1 ints of scratch.
extern "C" int k5_trsm_f32(const float* L, const float* B, float* X,
                           int* flags, int k, int c, int trans, int lcol,
                           void* stream) {
    return launch<float>(L, B, X, flags, k, c, trans, lcol, stream);
}

extern "C" int k5_trsm_f64(const double* L, const double* B, double* X,
                           int* flags, int k, int c, int trans, int lcol,
                           void* stream) {
    return launch<double>(L, B, X, flags, k, c, trans, lcol, stream);
}
