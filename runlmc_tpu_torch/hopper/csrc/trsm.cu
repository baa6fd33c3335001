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
// (DeviceWoodbury._cho_solve_C: jax.scipy.linalg.cho_solve), :313-337
// (kinv_diag: solve_triangular) and runlmc_tpu/lmc/likelihood.py:107-119
// (exact_mll's cho_solve), which XLA expands into blocked matmuls.
//
// Bound on the card: reading the triangle, k^2/2 elements (each right-hand
// side read and each solution written once besides), so k^2 elements for a
// cho_solve at narrow c; or k^2 c operations at the FP32/FP64 peak for
// wide c. Substitution itself is a chain of k dependent steps: for narrow
// c that chain, not the bytes, sets the time.
//
// The arithmetic, the same in every route (so routes agree to the bit):
// L is cut into row blocks of kNB = 64. Block i's running sum starts from
// B_i and takes away, in the order the blocks are solved (ascending,
// descending for trans), each coupling tile's 64 terms, summed apart in
// the order the solve produced them (p ascending, descending for trans):
// the rounding grows with the number of tiles, not with k. The 64 x 64
// diagonal block is then solved by substitution, each step's pivot
// applied as a reciprocal, in groups of four rows: the lane holding a
// group solves it alone, and four shuffles broadcast its x's to the lanes
// below (solve_diag): 16 rounds of shuffles a block, not 64. Every sum
// runs in a fixed order and nothing waits on data: a second launch is
// bit-identical and a NaN in L comes back as NaN in X without stalling a
// CTA.
//
// Narrow c (c <= 16: one right-hand side in training and in the oracle,
// 16 in the stochastic preconditioner): chains with helpers, one
// cooperative launch. Handing each block to the next through a flag
// between CTAs costs 5.5-6.6 us a block (poll, L2 round trips, fence), so
// one CTA per right-hand side, the chain, walks every block itself and
// keeps the solved block in shared memory: consecutive blocks pass nothing
// through memory. Its per-block floor is the substitution plus one
// coupling tile of 64 terms. Inside the chain, warps 0-7 take the near
// tile (from block i-1) away and solve block i, while warps 8-15 prepare
// block i+1: they copy its diagonal block and its two coupling tiles
// (cp.async), wait for its lagged sum H and take the far tile (from block
// i-1) away. The byte-bound part, H_i = B_i - sum_{j <= i-1-D} L_ij X_j
// over D = kLookahead, runs on helper CTAs that stream L's row bands once
// for every right-hand side (cp.async into a ring of kStages tiles), read
// the solved blocks through L2 once every chain's progress counter has
// passed them, and publish H_i with a release flag. H_i is due D blocks
// after the last block it reads was solved, which covers the helper's
// poll, read, tile sum and flag (on the card the sums are in well before
// the chain reads them). Which tiles the helpers sum and which the chain
// sums is fixed by (i, D). Progress: the launch is cooperative, so every
// CTA is co-resident (the grid, c chains then the helpers looping over
// row bands, is sized by cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// a chain waits only on H_{i+1}, whose helper waits only on blocks <= i-2
// that every chain has published, so no cycle of waits exists. A chain's
// progress is published by an aux thread, so that no solving warp waits
// for its stores to reach L2.
//
// Wide c (c > 16: the predict preconditioner's 151 columns, kinv_diag's
// 3113): one CTA owns one (block, tile of 16 or 64 right-hand sides),
// takes its block from an atomic ticket (not blockIdx), so it only ever
// waits on CTAs that started before it, adds up the coupling tiles of the
// blocks before it in the order they are published (prefetching each L
// tile into registers before it waits on that block's flag), solves its
// diagonal block and publishes it with a release flag; readers take the
// flag with an acquire load and read X_j through L2 (__ldcg).
//
// Flags, counters and tickets are zeroed by a cudaMemsetAsync on the
// launch's stream, so no state outlives a launch. A CTA that polls a flag
// kMaxPolls times traps.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kNB = 64;          // rows of a block
constexpr int kThreads = 256;    // a wide CTA; each half of the chain
constexpr int kChainThreads = 2 * kThreads;
constexpr int kHelperThreads = kChainThreads;
constexpr int kLds = kNB + 1;    // padded row of a shared L tile
constexpr int kTileElems = kNB * kNB / kThreads;  // L tile per thread
// the chain's own coupling tiles (the helpers sum the rest)
constexpr int kLookahead = 2;
// L tiles in flight in a helper
constexpr int kStages = 4;
// the widest c the per-block kernel takes in tiles of 16
constexpr int kWideCT16 = 1024;
// devices whose launch settings the chains remember
constexpr int kMaxDevices = 16;
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

// Polls until *p >= v and returns what it read.
__device__ __forceinline__ int wait_at_least(const int* p, int v,
                                             bool sleep) {
    int got;
    for (int polls = 0; (got = load_acquire(p)) < v; ++polls) {
        if (polls == kMaxPolls) __trap();
        if (sleep) __nanosleep(64);
    }
    return got;
}

// A barrier among the `n` threads of the warps that name `id` (1, 2; 0 is
// __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int n) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// The diagonal block in shared memory, blocked for the substitution:
// lane l of a half-warp reads the 4 x 4 block (rows 4l.., columns 4g..)
// of L (of L^T for trans) as four 16-byte rows. Blocks of one column
// group lie diag_bs apart, an odd number of 16-byte units, so the 8 lanes
// of a phase read distinct banks; column groups lie diag_gs apart, 16
// bytes past 16 blocks, so that the copies, whose neighbouring lanes may
// step from one column group to the next, write distinct banks too.
template <typename T>
__host__ __device__ constexpr int diag_bs() {
    return 16 + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int diag_gs() {
    return 16 * diag_bs<T>() + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int diag_elems() {
    return 16 * diag_gs<T>();
}

// Where element (a, b) of L's diagonal block lives.
template <typename T, bool TRANS>
__device__ __forceinline__ int diag_pos(int a, int b) {
    const int vr = TRANS ? b : a, vc = TRANS ? a : b;
    return (vc / 4) * diag_gs<T>() + (vr / 4) * diag_bs<T>() +
           (vr % 4) * 4 + vc % 4;
}

// One element of L into shared memory without passing through registers;
// outside the matrix the copy writes zero.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src,
                                              bool valid) {
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                 :: "r"(saddr), "l"(src), "n"(sizeof(T)),
                    "r"(valid ? (int)sizeof(T) : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Where a tile copy puts element (a, b) (row r0 + a, column c0 + b of L).
enum Layout {
    kRows,  // dst[a * kLds + b]
    kDiag,  // diag_pos, the lower triangle (b <= a) only
};

// The tile of L at (r0, c0), zero outside the matrix, into dst by `nthr`
// threads (a multiple of 64; thread `t`): each thread keeps one position
// along L's contiguous dimension, so neighbouring threads copy
// neighbouring addresses in either storage order, and steps along the
// other. kDiag leaves the strict upper triangle alone (never read into a
// result).
template <typename T, int LAYOUT, bool TRANS, bool LCOL>
__device__ __forceinline__ void tile_async(T* dst, const T* L, int k, int r0,
                                           int c0, int t, int nthr) {
    const int step = nthr / kNB, fixed = t % kNB, first = t / kNB;
    const int f = (LCOL ? r0 : c0) + fixed;  // along the contiguous dim
    const int m0 = LCOL ? c0 : r0;
    const bool fvalid = f < k;
    const T* src = L + (int64_t)(m0 + first) * k + f;
    const int64_t sstep = (int64_t)step * k;
    for (int m = first; m < kNB; m += step, src += sstep) {
        const int a = LCOL ? fixed : m, b = LCOL ? m : fixed;
        if (LAYOUT == kDiag && b > a) continue;
        const bool valid = fvalid && m0 + m < k;
        cp_async_elem(dst + (LAYOUT == kRows ? a * kLds + b
                                             : diag_pos<T, TRANS>(a, b)),
                      valid ? src : L, valid);
    }
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

// The row block solved at step s (descending for trans).
template <bool TRANS>
__device__ __forceinline__ int block_at(int s, int nblocks) {
    return TRANS ? nblocks - 1 - s : s;
}

// The coupling tile of L that takes block bj into block bi: rows of bi and
// columns of bj, or (trans) rows of bj and columns of bi.
template <typename T, bool TRANS, bool LCOL>
__device__ __forceinline__ void coupling_async(T* dst, const T* L, int k,
                                               int bi, int bj, int t,
                                               int nthr) {
    tile_async<T, kRows, TRANS, LCOL>(dst, L, k, TRANS ? bj * kNB : bi * kNB,
                                      TRANS ? bi * kNB : bj * kNB, t, nthr);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
}

// Row stride of a 64 x CT block of right-hand sides in shared memory:
// one column is stored contiguously; wider blocks past CT, in a whole
// number of 16-byte units.
template <typename T, int CT>
__host__ __device__ constexpr int xs_ld() {
    return CT == 1 ? 1
                   : (CT + 1 + 16 / (int)sizeof(T) - 1) /
                         (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// A thread's RM x RN entries (rows ty + i*TY, columns tx*RN + j) of a
// 64 x CT block: TX = CT / RN, TY = kNB / RM.
template <typename T, int CT, int RM, int RN>
struct Entries {
    static constexpr int TX = CT / RN;
    static constexpr int TY = kNB / RM;
    static constexpr int kUsed = TX * TY;  // threads with entries
    T v[RM][RN];
};

__device__ __forceinline__ void load16(const float* p, float* v) {
    load4(p, v);
}

__device__ __forceinline__ void load16(const double* p, double* v) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    v[0] = a.x;
    v[1] = a.y;
}

// RN consecutive elements from shared memory, in 16-byte loads where
// they fill them (the callers keep such rows 16-byte aligned).
template <typename T, int RN>
__device__ __forceinline__ void load_row(const T* p, T out[RN]) {
    constexpr int kPer = 16 / (int)sizeof(T);
    if constexpr (RN % kPer == 0) {
#pragma unroll
        for (int j = 0; j < RN; j += kPer) load16(p + j, out + j);
    } else {
#pragma unroll
        for (int j = 0; j < RN; ++j) out[j] = p[j];
    }
}

// The entries of B's block (rows row0.., columns col0..), zero outside.
template <typename T, int CT, int RM, int RN>
__device__ __forceinline__ void load_b(Entries<T, CT, RM, RN>& acc,
                                       const T* B, int k, int row0,
                                       int nrows, int col0, int ncols,
                                       int tx, int ty) {
    using E = Entries<T, CT, RM, RN>;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int r = ty + i * E::TY, cn = tx * RN + j;
            acc.v[i][j] = (r < nrows && cn < ncols)
                              ? B[(int64_t)(col0 + cn) * k + row0 + r]
                              : T(0);
        }
    }
}

// acc -= the tile's 64 terms summed apart: sum_p Lt[r, p] Xs[p, cn]
// (Lt[p, r] for trans), in the order the solve produces the x_p (p
// ascending; descending for trans).
template <typename T, int CT, int RM, int RN, bool TRANS>
__device__ __forceinline__ void take_tile(Entries<T, CT, RM, RN>& acc,
                                          const T* Lt, const T* Xs, int tx,
                                          int ty) {
    using E = Entries<T, CT, RM, RN>;
    constexpr int kXs = xs_ld<T, CT>();
    T part[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) part[i][j] = T(0);
    }
#pragma unroll 4
    for (int pp = 0; pp < kNB; ++pp) {
        const int p = TRANS ? kNB - 1 - pp : pp;
        T xv[RN], lv[RM];
        load_row<T, RN>(Xs + p * kXs + tx * RN, xv);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int r = ty + i * E::TY;
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
        for (int j = 0; j < RN; ++j) acc.v[i][j] -= part[i][j];
    }
}

template <typename T, int CT, int RM, int RN>
__device__ __forceinline__ void entries_to(T* Xs,
                                           const Entries<T, CT, RM, RN>& acc,
                                           int tx, int ty) {
    using E = Entries<T, CT, RM, RN>;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j)
            Xs[(ty + i * E::TY) * xs_ld<T, CT>() + tx * RN + j] = acc.v[i][j];
    }
}

// Row group g's 4 x 4 block of lane l's rows, and its reciprocal pivots.
template <typename T>
__device__ __forceinline__ void load_group(const T* Ld, const T* s_inv, int g,
                                           int l, T lv[4][4], T inv[4]) {
    const T* blk = Ld + g * diag_gs<T>() + l * diag_bs<T>();
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(blk + 4 * i, lv[i]);
    load4(s_inv + 4 * g, inv);
}

// Substitution of the diagonal block on the running sums in Xs (64 x CT,
// row stride xs_ld), in the order of plain substitution: step r takes
// x_r = v_r * (1 / L_rr), then v_a -= L_ar x_r for the rows a after it
// (before it, for trans). Half-warp h of warp w solves the CW = CT / 16
// right-hand sides (2w + h) CW .. (at least one); its lane l holds rows
// 4l .. 4l + 3 of each. The steps go in groups of four rows: the lane
// that holds them (the owner) solves the group alone, then four shuffles
// broadcast its x's and every later lane takes them from its rows in
// order. A block costs 16 rounds of shuffles, not 64, and each row sees
// the same operations in the same order. Writes X (column stride k, at
// the block's first row) and, when Xr is given, the solved block there.
template <typename T, int CT, bool TRANS>
__device__ __forceinline__ void solve_diag(const T* Xs, const T* Ld,
                                           const T* s_inv, int nrows,
                                           int ncols, T* Xg, int k, T* Xr,
                                           int warp, int lane) {
    constexpr int kXs = xs_ld<T, CT>();
    constexpr int CW = CT >= 16 ? CT / 16 : 1;
    const int h = lane / 16, l = lane % 16;
    const int c0 = (warp * 2 + h) * CW;  // the half-warp's first column
    if ((warp * 2) * CW >= ncols) return;  // the same in the warp
    const int ngroups = (nrows + 3) / 4;
    constexpr int dg = TRANS ? -1 : 1;
    T v[CW][4];
#pragma unroll
    for (int q = 0; q < CW; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[q][i] = Xs[(4 * l + i) * kXs + c0 + q];
    }
    int g = TRANS ? ngroups - 1 : 0;
#pragma unroll 1
    for (int it = 0; it < ngroups; ++it, g += dg) {
        T lv[4][4], inv[4];
        load_group(Ld, s_inv, g, l, lv, inv);
        const bool upd = TRANS ? l < g : l > g;
        const bool own = l == g;
#pragma unroll
        for (int q = 0; q < CW; ++q) {
            T w[4], x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) w[i] = v[q][i];
            if (TRANS) {
                x[3] = w[3] * inv[3];
                w[2] -= lv[2][3] * x[3];
                w[1] -= lv[1][3] * x[3];
                w[0] -= lv[0][3] * x[3];
                x[2] = w[2] * inv[2];
                w[1] -= lv[1][2] * x[2];
                w[0] -= lv[0][2] * x[2];
                x[1] = w[1] * inv[1];
                w[0] -= lv[0][1] * x[1];
                x[0] = w[0] * inv[0];
            } else {
                x[0] = w[0] * inv[0];
                w[1] -= lv[1][0] * x[0];
                w[2] -= lv[2][0] * x[0];
                w[3] -= lv[3][0] * x[0];
                x[1] = w[1] * inv[1];
                w[2] -= lv[2][1] * x[1];
                w[3] -= lv[3][1] * x[1];
                x[2] = w[2] * inv[2];
                w[3] -= lv[3][2] * x[2];
                x[3] = w[3] * inv[3];
            }
            T xg[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                xg[j] = __shfl_sync(0xffffffffu, x[j], g, 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                T u = v[q][i];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const int j = TRANS ? 3 - jj : jj;
                    u -= lv[i][j] * xg[j];
                }
                v[q][i] = upd ? u : (own ? x[i] : v[q][i]);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < CW; ++q) {
        const int cn = c0 + q;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (Xr != nullptr && cn < ncols)
                Xr[(4 * l + i) * kXs + cn] = v[q][i];
            if (cn < ncols && 4 * l + i < nrows)
                Xg[(int64_t)cn * k + 4 * l + i] = v[q][i];
        }
    }
}

// ------------------------------------------------------------- wide c

// CT right-hand sides per CTA; each thread keeps an RM x RN tile of the
// block's running sums. Two CTAs an SM: left alone, ptxas gives the
// column-major transposed instance so many registers that only one CTA
// fits an SM, and it ran the slowest of the four.
template <typename T, int CT, int RN, bool TRANS, bool LCOL>
__global__ void __launch_bounds__(kThreads, 2)
k5_trsm_lower(const T* __restrict__ L, const T* __restrict__ B, T* X,
              int* flags, int k, int c, int nblocks, int ntiles) {
    constexpr int RM = kNB / (kThreads / (CT / RN));
    using E = Entries<T, CT, RM, RN>;
    constexpr int kXs = xs_ld<T, CT>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ld = reinterpret_cast<T*>(smem_raw);  // diagonal block (diag_pos)
    T* Lt = Ld + diag_elems<T>();            // kNB x kLds, coupling tile
    T* Xs = Lt + kNB * kLds;                 // kNB x kXs
    __shared__ __align__(16) T s_inv[kNB];
    __shared__ int s_ticket;

    const int tid = threadIdx.x;
    if (tid == 0) s_ticket = atomicAdd(&flags[nblocks * ntiles], 1);
    __syncthreads();
    const int ticket = s_ticket;
    const int tile = ticket % ntiles;
    const int step = ticket / ntiles;
    const int bi = block_at<TRANS>(step, nblocks);
    const int row0 = bi * kNB;
    const int nrows = min(kNB, k - row0);
    const int col0 = tile * CT;
    const int ncols = min(CT, c - col0);
    const int tx = tid % E::TX, ty = tid / E::TX;

    // the diagonal block and its reciprocal pivots first: they depend on
    // nothing, so they leave the chain of waits
#pragma unroll
    for (int e = 0; e < kTileElems; ++e) {
        int a, b;
        tile_coords<LCOL>(tid, e, &a, &b);
        Ld[diag_pos<T, TRANS>(a, b)] =
            (a < nrows && b < nrows)
                ? load_l<T, LCOL>(L, k, row0 + a, row0 + b)
                : T(0);
    }
    __syncthreads();
    if (tid < kNB)
        s_inv[tid] = tid < nrows ? T(1) / Ld[diag_pos<T, TRANS>(tid, tid)]
                                 : T(0);

    E acc;
    load_b(acc, B, k, row0, nrows, col0, ncols, tx, ty);

    // the blocks solved before this one, in the order they are published
    for (int s = 0; s < step; ++s) {
        const int bj = block_at<TRANS>(s, nblocks);
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
        if (tid == 0) wait_at_least(flags + bj * ntiles + tile, 1, false);
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
        take_tile<T, CT, RM, RN, TRANS>(acc, Lt, Xs, tx, ty);
        __syncthreads();
    }

    entries_to(Xs, acc, tx, ty);
    __syncthreads();
    solve_diag<T, CT, TRANS>(Xs, Ld, s_inv, nrows, ncols,
                             X + (int64_t)col0 * k + row0, k, nullptr,
                             tid / 32, tid % 32);
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flags + bi * ntiles + tile, 1);
}

// ------------------------------------------------------------ narrow c

// Each chain solves one right-hand side: a half holds 64 x 1 entries, one
// to each of its first 64 threads. A helper sums CT = 1 or 16 columns
// (every chain's): 512 threads hold 64 x CT entries, one or two each.
template <int CT> struct HelperLayout;
template <> struct HelperLayout<1> {
    static constexpr int kRM = 1, kRN = 1;
};
template <> struct HelperLayout<16> {
    static constexpr int kRM = 1, kRN = 2;
};

template <typename T>
__host__ __device__ constexpr size_t chain_smem() {
    // diagonal blocks (diag_pos) and near tiles (two each), the far tile,
    // the solved blocks, the prepared sums and the reciprocal pivots (two
    // each)
    return sizeof(T) * ((size_t)2 * diag_elems<T>() + 3 * kNB * kLds +
                        6 * kNB);
}

template <typename T, int CT>
__host__ __device__ constexpr size_t helper_smem() {
    return sizeof(T) * ((size_t)kStages * kNB * kLds + kNB * xs_ld<T, CT>());
}

template <typename T, int CT>
__host__ __device__ constexpr size_t narrow_smem() {
    return chain_smem<T>() > helper_smem<T, CT>() ? chain_smem<T>()
                                                   : helper_smem<T, CT>();
}

// Chain cn (blockIdx.x, one per right-hand side; see the note at the head
// of the file). Warps 0-7 ("main") solve step s; warps 8-15 ("aux")
// prepare step s + 1 in buffers of the other parity: its diagonal block,
// its near and far coupling tiles, its helpers' sum H less the far tile's
// terms. The last aux thread publishes the chain's progress (flags[cn])
// while the first waits for H, so that no solving warp waits for its
// stores to reach L2. P holds the helpers' sums, CT columns a block;
// flags[nchains + i] says block i's are in.
template <typename T, int CT, bool TRANS, bool LCOL>
__device__ void chain(const T* L, const T* B, T* X, const T* P, int* flags,
                      int k, int nchains, int nblocks, T* sm) {
    using EM = Entries<T, 1, 1, 1>;  // row t of the half's first 64
    const int cn = blockIdx.x;       // the right-hand side
    // buffers of parity p at base + p * stride (p is a run-time value:
    // arrays of pointers would live in local memory)
    T* const Ld0 = sm;                         // diagonal blocks, diag_pos
    T* const Ln0 = Ld0 + 2 * diag_elems<T>();  // near tiles
    T* const Lf = Ln0 + 2 * kNB * kLds;        // far tile
    T* const Xr0 = Lf + kNB * kLds;            // solved blocks
    T* const A0 = Xr0 + 2 * kNB;               // prepared sums
    T* const inv0 = A0 + 2 * kNB;              // pivots, 16-byte aligned

    const int tid = threadIdx.x;
    for (int e = tid; e < (int)(chain_smem<T>() / sizeof(T));
         e += kChainThreads)
        sm[e] = T(0);
    __syncthreads();

    const bool aux = tid >= kThreads;
    const int t = tid % kThreads;  // index within the half
    const bool publisher = aux && t == kThreads - 1;
    const bool has = t < EM::kUsed;
    const T* Bc = B + (int64_t)cn * k;
    T* Xc = X + (int64_t)cn * k;

    for (int s = -1; s < nblocks; ++s) {
        const int cur = s & 1, nxt = cur ^ 1;
        if (!aux) {
            if (s >= 0) {
                const int bi = block_at<TRANS>(s, nblocks);
                T* const Acur = A0 + cur * kNB;
                if (s >= 1 && has) {
                    EM acc;
                    acc.v[0][0] = Acur[t];
                    take_tile<T, 1, 1, 1, TRANS>(acc, Ln0 + cur * kNB * kLds,
                                                 Xr0 + nxt * kNB, 0, t);
                    Acur[t] = acc.v[0][0];
                }
                named_barrier(1, kThreads);
                solve_diag<T, 1, TRANS>(
                    Acur, Ld0 + cur * diag_elems<T>(), inv0 + cur * kNB,
                    min(kNB, k - bi * kNB), 1, Xc + bi * kNB, k,
                    Xr0 + cur * kNB, t / 32, t % 32);
            }
        } else if (s + 1 >= nblocks) {
            // blocks 0 .. s - 1 are in X: the helpers may read them
            if (publisher && s >= 1) store_release(flags + cn, s);
        } else {
            // prepare step s + 1: its diagonal block, its near tile (from
            // block s, the main half's) and far tile (from block s - 1)
            const int st = s + 1;
            const int bt = block_at<TRANS>(st, nblocks);
            const int row0 = bt * kNB, nrows = min(kNB, k - row0);
            tile_async<T, kDiag, TRANS, LCOL>(Ld0 + nxt * diag_elems<T>(), L,
                                              k, row0, row0, t, kThreads);
            if (st >= 1)
                coupling_async<T, TRANS, LCOL>(
                    Ln0 + nxt * kNB * kLds, L, k, bt,
                    block_at<TRANS>(st - 1, nblocks), t, kThreads);
            if (st >= 2)
                coupling_async<T, TRANS, LCOL>(
                    Lf, L, k, bt, block_at<TRANS>(st - 2, nblocks), t,
                    kThreads);
            cp_async_commit();
            if (publisher && s >= 1) store_release(flags + cn, s);
            EM acc;
            if (st > kLookahead) {
                // the helpers' sum over the blocks before st - kLookahead
                if (t == 0)
                    wait_at_least(flags + nchains + bt, 1, false);
                named_barrier(2, kThreads);
                if (has)
                    acc.v[0][0] =
                        __ldcg(P + ((int64_t)bt * CT + cn) * kNB + t);
            } else if (has) {
                acc.v[0][0] = t < nrows ? Bc[row0 + t] : T(0);
            }
            cp_async_wait<0>();
            named_barrier(2, kThreads);
            if (t < kNB)
                inv0[nxt * kNB + t] =
                    t < nrows ? T(1) / Ld0[nxt * diag_elems<T>() +
                                           diag_pos<T, TRANS>(t, t)]
                              : T(0);
            if (has) {
                if (st >= 2)
                    take_tile<T, 1, 1, 1, TRANS>(acc, Lf, Xr0 + nxt * kNB, 0,
                                                 t);
                A0[nxt * kNB + t] = acc.v[0][0];
            }
        }
        __syncthreads();
    }
}

__host__ __device__ constexpr int xper(int ct) {
    return (kNB * ct + kHelperThreads - 1) / kHelperThreads;
}

// A helper thread's entries of X for the block solved at step j (read
// through L2: the chains wrote them on other SMs).
template <typename T, int CT, bool TRANS>
__device__ __forceinline__ void load_x(T (&xr)[xper(CT)], const T* X, int k,
                                       int ncols, int j, int nblocks,
                                       int tid) {
    const int bj = block_at<TRANS>(j, nblocks);
    const int jrows = min(kNB, k - bj * kNB);
#pragma unroll
    for (int q = 0; q < xper(CT); ++q) {
        const int e = tid + q * kHelperThreads;
        const int p = e % kNB, cn = e / kNB;
        xr[q] = (e < kNB * CT && p < jrows && cn < ncols)
                    ? __ldcg(X + (int64_t)cn * k + bj * kNB + p)
                    : T(0);
    }
}

// Every thread: waits until each chain has published `need` steps, and
// returns the least progress read (a barrier inside).
__device__ __forceinline__ int wait_chains(const int* flags, int nchains,
                                           int need, int* s_prog) {
    if ((int)threadIdx.x < nchains)
        s_prog[threadIdx.x] = wait_at_least(flags + threadIdx.x, need, true);
    __syncthreads();
    int prog = s_prog[0];
    for (int i = 1; i < nchains; ++i) prog = min(prog, s_prog[i]);
    return prog;
}

// A helper (blockIdx.x nchains + g of nchains + G): the lagged sums of
// steps kLookahead + 1 + g, + G, ..., each over the tiles of steps 0 ..
// s - 1 - kLookahead in order, for every right-hand side, published to P
// with a release flag.
template <typename T, int CT, bool TRANS, bool LCOL>
__device__ void helper(const T* L, const T* B, const T* X, T* P, int* flags,
                       int k, int c, int nchains, int nblocks, T* sm) {
    using HL = HelperLayout<CT>;
    using EH = Entries<T, CT, HL::kRM, HL::kRN>;
    constexpr int kXs = xs_ld<T, CT>();
    constexpr int kXper = xper(CT);
    T* Ls = sm;                          // kStages x kNB x kLds
    T* Xs = sm + kStages * kNB * kLds;   // kNB x kXs
    __shared__ int s_prog[16];

    const int tid = threadIdx.x;
    const int g = blockIdx.x - nchains, G = gridDim.x - nchains;
    const int tx = tid % EH::TX, ty = tid / EH::TX;
    const bool has = tid < EH::kUsed;
    const int ncols = min(CT, c);
    int prog = 0;  // steps every chain has published, the same in all

    for (int s = kLookahead + 1 + g; s < nblocks; s += G) {
        const int bi = block_at<TRANS>(s, nblocks);
        const int row0 = bi * kNB, nrows = min(kNB, k - row0);
        const int ntl = s - kLookahead;  // tiles of steps 0 .. ntl - 1
        EH acc;
        if (has) load_b(acc, B, k, row0, nrows, 0, ncols, tx, ty);
#pragma unroll
        for (int q = 0; q < kStages - 1; ++q) {
            if (q < ntl)
                coupling_async<T, TRANS, LCOL>(
                    Ls + q * kNB * kLds, L, k, bi,
                    block_at<TRANS>(q, nblocks), tid, kHelperThreads);
            cp_async_commit();
        }
        if (prog < 1) prog = wait_chains(flags, nchains, 1, s_prog);
        T xr[kXper];
        load_x<T, CT, TRANS>(xr, X, k, ncols, 0, nblocks, tid);
        for (int j = 0; j < ntl; ++j) {
            // xr holds X of step j; the barrier ending step j - 1 is behind
#pragma unroll
            for (int q = 0; q < kXper; ++q) {
                const int e = tid + q * kHelperThreads;
                if (e < kNB * CT) Xs[(e % kNB) * kXs + e / kNB] = xr[q];
            }
            cp_async_wait<kStages - 2>();  // tile j is in
            __syncthreads();
            const int q = j + kStages - 1;  // into the stage read at j - 1
            if (q < ntl)
                coupling_async<T, TRANS, LCOL>(
                    Ls + (q % kStages) * kNB * kLds, L, k, bi,
                    block_at<TRANS>(q, nblocks), tid, kHelperThreads);
            cp_async_commit();
            const bool more = j + 1 < ntl;
            const bool known = prog > j + 1;
            if (more && known)  // in flight over the sum
                load_x<T, CT, TRANS>(xr, X, k, ncols, j + 1, nblocks, tid);
            if (has)
                take_tile<T, CT, HL::kRM, HL::kRN, TRANS>(
                    acc, Ls + (j % kStages) * kNB * kLds, Xs, tx, ty);
            if (more && !known) {
                prog = wait_chains(flags, nchains, j + 2, s_prog);
                load_x<T, CT, TRANS>(xr, X, k, ncols, j + 1, nblocks, tid);
            } else {
                __syncthreads();
            }
        }
        if (has) {
#pragma unroll
            for (int i = 0; i < HL::kRM; ++i) {
#pragma unroll
                for (int jj = 0; jj < HL::kRN; ++jj) {
                    const int r = ty + i * EH::TY, cq = tx * HL::kRN + jj;
                    P[((int64_t)bi * CT + cq) * kNB + r] = acc.v[i][jj];
                }
            }
        }
        __syncthreads();
        if (tid == 0) store_release(flags + nchains + bi, 1);
    }
}

template <typename T, int CT, bool TRANS, bool LCOL>
__global__ void __launch_bounds__(kChainThreads, 1)
k5_trsm_narrow(const T* __restrict__ L, const T* __restrict__ B, T* X, T* P,
               int* flags, int k, int c, int nblocks) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    if ((int)blockIdx.x < c)
        chain<T, CT, TRANS, LCOL>(L, B, X, P, flags, k, c, nblocks, sm);
    else
        helper<T, CT, TRANS, LCOL>(L, B, X, P, flags, k, c, c, nblocks, sm);
}

template <typename T, int CT, bool TRANS, bool LCOL>
int launch_narrow(const T* L, const T* B, T* X, T* P, int* flags, int k,
                  int c, cudaStream_t stream) {
    const int nblocks = (k + kNB - 1) / kNB;
    const size_t smem = narrow_smem<T, CT>();
    auto kern = k5_trsm_narrow<T, CT, TRANS, LCOL>;
    // the shared-memory opt-in and the co-resident CTAs, once a device
    static int capacity[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (capacity[dev] == 0) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        int nsm = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, kChainThreads, smem);
        if (err != cudaSuccess) return (int)err;
        capacity[dev] = per_sm * nsm;
    }
    if (capacity[dev] <= c) return (int)cudaErrorCooperativeLaunchTooLarge;
    const int cap = capacity[dev];
    // a chain per right-hand side, then one helper per lagged row band,
    // as many as are co-resident
    const int bands = nblocks - kLookahead - 1;
    const int helpers = std::max(0, std::min(bands, cap - c));
    err = cudaMemsetAsync(flags, 0, sizeof(int) * ((size_t)c + nblocks),
                          stream);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&L, (void*)&B, (void*)&X, (void*)&P,
                    (void*)&flags, (void*)&k, (void*)&c, (void*)&nblocks};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(c + helpers),
                                      dim3(kChainThreads), args, smem,
                                      stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename T, bool TRANS, bool LCOL>
int launch_wide(const T* L, const T* B, T* X, int* flags, int k, int c,
                cudaStream_t stream) {
    constexpr int CT = 64, RN = 4;
    const int nblocks = (k + kNB - 1) / kNB;
    const int ntiles = (c + CT - 1) / CT;
    const size_t smem = sizeof(T) * ((size_t)diag_elems<T>() +
                                     (size_t)kNB * (kLds + xs_ld<T, CT>()));
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

// The per-block kernel in tiles of 16: the chains' yardstick at c <= 16
// (it sums in the same order, so the two agree to the bit), and the
// route for moderate c.
template <typename T, bool TRANS, bool LCOL>
int launch_blockwise(const T* L, const T* B, T* X, int* flags, int k, int c,
                     cudaStream_t stream) {
    constexpr int CT = 16, RN = 2;
    const int nblocks = (k + kNB - 1) / kNB;
    const int ntiles = (c + CT - 1) / CT;
    const size_t smem = sizeof(T) * ((size_t)diag_elems<T>() +
                                     (size_t)kNB * (kLds + xs_ld<T, CT>()));
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

// route 0: the chains for c <= 16 (helpers of one column for c = 1, of
// 16 otherwise), the per-block kernel in tiles of 16 up to kWideCT16
// columns (more CTAs a block: faster at the predict preconditioner's 151
// columns), in tiles of 64 past it (faster at kinv_diag's 3113);
// route 1: the per-block kernel in tiles of 16 at any c.
template <typename T, bool TRANS, bool LCOL>
int launch_route(const T* L, const T* B, T* X, T* P, int* flags, int k,
                 int c, int route, cudaStream_t st) {
    if (route == 1)
        return launch_blockwise<T, TRANS, LCOL>(L, B, X, flags, k, c, st);
    if (c == 1)
        return launch_narrow<T, 1, TRANS, LCOL>(L, B, X, P, flags, k, c, st);
    if (c <= 16)
        return launch_narrow<T, 16, TRANS, LCOL>(L, B, X, P, flags, k, c,
                                                 st);
    if (c <= kWideCT16)
        return launch_blockwise<T, TRANS, LCOL>(L, B, X, flags, k, c, st);
    return launch_wide<T, TRANS, LCOL>(L, B, X, flags, k, c, st);
}

template <typename T>
int launch(const T* L, const T* B, T* X, T* P, int* flags, int k, int c,
           int trans, int lcol, int route, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (trans)
        return lcol ? launch_route<T, true, true>(L, B, X, P, flags, k, c,
                                                  route, st)
                    : launch_route<T, true, false>(L, B, X, P, flags, k, c,
                                                   route, st);
    return lcol ? launch_route<T, false, true>(L, B, X, P, flags, k, c, route,
                                               st)
                : launch_route<T, false, false>(L, B, X, P, flags, k, c,
                                                route, st);
}

}  // namespace

// flags: at least ceil(k / 64) * ceil(c / 16) + 1 ints of scratch, and
// ceil(k / 64) + c when c <= 16; P (the helpers' sums): ceil(k / 64) * 64
// * 16 elements when c <= 16, else unused.
extern "C" int k5_trsm_f32(const float* L, const float* B, float* X,
                           float* P, int* flags, int k, int c, int trans,
                           int lcol, int route, void* stream) {
    return launch<float>(L, B, X, P, flags, k, c, trans, lcol, route, stream);
}

extern "C" int k5_trsm_f64(const double* L, const double* B, double* X,
                           double* P, int* flags, int k, int c, int trans,
                           int lcol, int route, void* stream) {
    return launch<double>(L, B, X, P, flags, k, c, trans, lcol, route,
                          stream);
}
