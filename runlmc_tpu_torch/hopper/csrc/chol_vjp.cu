// The Cholesky factorization's VJP (K3's backward through the factor):
// for A = L L^T and a cotangent L-bar of L's lower triangle,
//
//   A-bar = 1/2 (X + X^T),  X = L^-T S L^-1,  S = 1/2 (P + P^T),
//   P = Phi(L^T L-bar),
//
// Phi keeping the lower triangle with its diagonal halved, which is what
// XLA's autodiff of jnp.linalg.cholesky computes (its JVP uses Phi and
// jnp.linalg.cholesky symmetrizes its input). X is symmetric, so A-bar
// is X made exactly symmetric. Replaces XLA's autodiff of the Cholesky in
// runlmc_tpu/lmc/woodbury.py:121 (chol_jittered, on the exact objective's
// factors F of K_UU and L_C of C), where XLA runs a full GEMM L^T L-bar,
// the triangle ops and two n-column triangular solves. Two entry points:
//
//   tri    S: for a >= b, G_ab = sum_{k >= a} L_ka L-bar_kb (only the
//          lower triangles enter), S_ab = S_ba = G_ab / 2;
//   solve  A-bar = L^-T S L^-1, in two kernels: pack (L's lower tiles
//          into a packed tile-major copy) and solve (both block
//          substitutions).
//
// Bound on the card: operations. tri does n^3 / 3 (the lower triangle of
// a product whose inner sums start at the row index); solve 4 n^3 / 3:
// n^3 for Y = L^-T S and n^3 / 3 for the lower triangle of X = L^-T Y^T
// (X is symmetric, X = X^T = L^-T Y^T), where two general triangular
// solves do 2 n^3; both at 67 TFLOP/s (FFMA in float32, DMMA in float64).
//
// The tile machinery of tri and solve: 64 x 64 output tiles, 128
// threads; the depth comes through a ring of kStages slices of 16 rows of
// both operands in shared memory, filled by cp.async. Float32 (FmaCore):
// an 8 x 4 register tile a thread, each sum in ascending depth through
// fmaf. Float64 (MmaCore): a 32 x 32 tile a warp on
// mma.sync.m16n8k8.f64 (DMMA; m8n8k4 runs at half the H100's FP64 tensor
// rate).
//
// tri: the (a-tile, b-tile) pairs, a-tile >= b-tile, in a host work list,
// deepest inner range first, taken by persistent CTAs from an atomic
// ticket. Slices of L[k, a-tile] and L-bar[k, b-tile] masked to the lower
// triangles, copied along the rows of a row-major operand and by 32-byte
// sectors down the columns of a column-major one (cuSOLVER leaves L so).
// Float32 sums each entry over k ascending from its a-tile's first row
// (the terms above the diagonal are exact zeros), as the earlier
// one-CTA-per-tile SIMT kernel did, so S keeps its bits; route 1 (a
// thread an entry, k ascending from a) sums in that order and is the
// yardstick.
//
// solve: by blocks of 64 rows,
//
//   L_II^T Y_I  = S_I    - sum_{J > I} L_JI^T Y_J   (every column tile c)
//   L_II^T X_IK = Y_KI^T - sum_{J > I} L_JI^T X_JK  (K <= I only)
//
// so column tile K of X reads only X's lower block triangle: no entry
// above it is formed. A work item is (stage, I, c); the host list puts
// stage 0 (Y's block (I, c)) for I descending, then stage 1 (X's block
// (I, K)) for I descending. A CTA takes its item from an atomic ticket at
// its start, so it only ever waits on items that started before it (no
// deadlock, whatever is resident). It starts from its right-hand side
// (S's block, or Y's block (K, I) transposed) and adds the coupling
// products with -L_JI's packed tiles in the order the blocks are
// published: a block's Y (or X) tile is copied only after its release
// flag has been read (acquire; the copies go through L2), and a block not
// yet published is probed again at each slice, so the slices already in
// are summed while it is awaited; the CTA blocks only when the ring has
// run dry. Float32 sums each block's product apart and adds it into a
// running total with Kahan's compensation (FmaCore::flush). L_II's rows
// come through the ring behind the last block; the 64 x 64 block is then
// solved by substitution in registers (solve_block): the chain from one
// row block to the next is one coupling product and one block
// substitution. Coupling tiles premultiplied by inverted diagonal
// blocks (N_JI = -L_JI L_II^-1, a chain of one product) ran faster, but
// their rounding grows with the diagonal blocks' condition: on synth's
// nearly singular float64 K_UU (jitter 1e-12) chip_smoke.py's float64
// card-vs-CPU training chunk drifted past its bound. Stage
// 0 writes Y's tile and its flag; stage 1 writes X's tile into scratch
// (Z) and its flag, then A-bar's entries and their mirrors from the same
// values (on a diagonal tile, the lower half and its mirror), so A-bar
// is exactly symmetric and no pass symmetrizes it afterwards.
//
// Every sum runs in a fixed order, with no atomics on data and no split
// of a sum across CTAs: a second launch is bit-identical. Nothing waits on
// data, so a NaN in L or S comes back as NaN without stalling a CTA;
// flags and tickets are zeroed on the launch's stream, and a CTA that
// polls a flag kMaxPolls times traps (a launch error, not a hung card).

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kT = 64;                 // tile edge, rows of a block
constexpr int kBK = 16;                // rows of a ring slice
constexpr int kSub = kT / kBK;         // slices of a tile
constexpr int kStages = 4;             // slices in the ring
constexpr int kLd = kT + 4;            // row of a staged slice: 4 mod 16
                                       // doubles, DMMA fragments and
                                       // column copies bank-conflict-free
constexpr int kEld = kT + 1;           // row of an epilogue tile
constexpr int kSlot = 2 * kBK * kLd;   // a ring slot: X, then Y
constexpr int kThreads = 128;
constexpr int kPackThreads = 256;
constexpr int kTile = kT * kT;
constexpr int kSeq = 16;               // route 1's thread-block edge
constexpr int kMaxDevices = 16;
constexpr int kMaxPolls = 1 << 26;
static_assert(kStages >= kSub && kStages * kSlot >= kT * kEld,
              "the diagonal product and the epilogue tile fit the ring");

template <typename T>
constexpr size_t ring_bytes() {
    return sizeof(T) * (size_t)kStages * kSlot;
}

// a * b + c, rounded once (FFMA / DFMA)
__device__ __forceinline__ float madd(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
    return fma(a, b, c);
}

// One element into shared memory without passing through registers;
// where ``valid`` is false the copy writes zero.
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

// 16 bytes, read through L2 (the tiles other CTAs publish)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
    const unsigned saddr =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(saddr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// all but the newest ``pending`` groups in (0 <= pending < kStages)
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
    static_assert(kStages == 4, "one case a pending count");
    if (pending <= 0) {
        cp_async_wait<0>();
    } else if (pending == 1) {
        cp_async_wait<1>();
    } else if (pending == 2) {
        cp_async_wait<2>();
    } else {
        cp_async_wait<3>();
    }
}

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

// Every thread returns once *flag is set (thread 0 polls; a barrier).
__device__ __forceinline__ void wait_flag(const int* flag) {
    if (threadIdx.x == 0) {
        for (int polls = 0; load_acquire(flag) == 0; ++polls) {
            if (polls == kMaxPolls) __trap();
        }
    }
    __syncthreads();
}

// The CTA's global stores, then *flag = 1 with release semantics.
__device__ __forceinline__ void publish(int* flag) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) store_release(flag, 1);
}

// (a-tile, b-tile) of the p-th lower-triangular pair, a-tile >= b-tile,
// enumerated row by row: (0,0), (1,0), (1,1), (2,0), ...; p is also the
// pair's packed tile index (tri_index).
__device__ __forceinline__ void pair_of(int64_t p, int& ta, int& tb) {
    int t = (int)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
    while ((int64_t)(t + 1) * (t + 2) / 2 <= p) ++t;
    while ((int64_t)t * (t + 1) / 2 > p) --t;
    ta = t;
    tb = (int)(p - (int64_t)t * (t + 1) / 2);
}

__host__ __device__ __forceinline__ int64_t tri_index(int J, int I) {
    return (int64_t)J * (J + 1) / 2 + I;
}

// Float32: a 16 x 8 grid of threads, each an 8 x 4 register tile: rows
// (i / 4) 32 + 4 ty + i % 4, columns 4 tx + j, so that its operands come
// in 16-byte loads. acc[row][col] += sum_k X[k][row] Y[k][col], k
// ascending, one fmaf a term. flush() adds the sum so far into a running
// total ``tot`` with Kahan's compensation ``comp`` and starts a new sum,
// settle() brings the total back: the solve sums each 64-deep product
// apart and adds the products almost exactly (one running sum over all
// n terms came out less accurate than cuBLAS's solves); the tri kernel
// never flushes (its bits).
struct FmaCore {
    using T = float;
    float acc[8][4], tot[8][4], comp[8][4];
    int tx, ty;

    __device__ FmaCore()
        : tx((int)threadIdx.x % 16), ty((int)threadIdx.x / 16) {}
    __device__ int row(int i) const { return (i / 4) * 32 + ty * 4 + i % 4; }
    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = comp[i][j] = 0.f;
    }
    __device__ void flush() {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float y = acc[i][j] - comp[i][j];
                const float t = tot[i][j] + y;
                comp[i][j] = (t - tot[i][j]) - y;
                tot[i][j] = t;
                acc[i][j] = 0.f;
            }
    }
    __device__ void settle() {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] = tot[i][j];
                tot[i][j] = 0.f;
            }
    }
    __device__ void compute(const float* sx, const float* sy) {
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(sx + k * kLd + ty * 4);
            const float4 a1 =
                *reinterpret_cast<const float4*>(sx + k * kLd + 32 + ty * 4);
            const float4 b =
                *reinterpret_cast<const float4*>(sy + k * kLd + tx * 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                a1.x, a1.y, a1.z, a1.w};
            const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
    }
    template <class F>
    __device__ void each(F f) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) f(row(i), tx * 4 + j, acc[i][j]);
    }
    // s times the tile into a row-major 64 x 64 tile, 16-byte stores
    __device__ void store_tile(float* out, float s) const {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            *reinterpret_cast<float4*>(out + row(i) * kT + tx * 4) =
                make_float4(s * acc[i][0], s * acc[i][1], s * acc[i][2],
                            s * acc[i][3]);
    }
};

// Float64: 2 x 2 warps, each a 32 x 32 tile of 16 x 8 DMMA tiles,
// mma.sync.aligned.m16n8k8.row.col.f64 (with g = l / 4 and t = l % 4 for
// lane l, a_i holds A[g + 8 (i % 2)][t + 4 (i / 2)], b_i B[t + 4 i][g],
// c_i C[g + 8 (i / 2)][2 t + i % 2]). One running sum: float64 needs no
// partial sums (the solve agrees with cuBLAS's to 1e-14 without them).
struct MmaCore {
    using T = double;
    double acc[2][4][4];
    int g, t, wm0, wn0;

    __device__ MmaCore() {
        const int lane = (int)threadIdx.x % 32, w = (int)threadIdx.x / 32;
        g = lane / 4;
        t = lane % 4;
        wm0 = (w / 2) * 32;
        wn0 = (w % 2) * 32;
    }
    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
    }
    __device__ void flush() {}
    __device__ void settle() {}
    __device__ void compute(const double* sx, const double* sy) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
            double a[2][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    a[i][q] = sx[(kk + t + 4 * (q / 2)) * kLd + wm0 + i * 16 +
                                 g + 8 * (q % 2)];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int q = 0; q < 2; ++q)
                    b[j][q] = sy[(kk + t + 4 * q) * kLd + wn0 + j * 8 + g];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    asm volatile(
                        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                        "{%0, %1, %2, %3};"
                        : "+d"(acc[i][j][0]), "+d"(acc[i][j][1]),
                          "+d"(acc[i][j][2]), "+d"(acc[i][j][3])
                        : "d"(a[i][0]), "d"(a[i][1]), "d"(a[i][2]),
                          "d"(a[i][3]), "d"(b[j][0]), "d"(b[j][1]));
        }
    }
    template <class F>
    __device__ void each(F f) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    f(wm0 + i * 16 + g + 8 * (q / 2), wn0 + j * 8 + 2 * t + q % 2,
                      acc[i][j][q]);
    }
    __device__ void store_tile(double* out, double s) const {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<double2*>(
                        out + (wm0 + i * 16 + g + 8 * h) * kT + wn0 + j * 8 +
                        2 * t) = make_double2(s * acc[i][j][2 * h],
                                              s * acc[i][j][2 * h + 1]);
    }
};

template <typename T> struct CoreOf;
template <> struct CoreOf<float> { using type = FmaCore; };
template <> struct CoreOf<double> { using type = MmaCore; };

// The copies of a kBK x kT slice that a thread makes: the i-th at (r +
// dr(i), c + dc(i)). Along the rows (DF false) neighbouring threads take
// neighbouring columns; down the columns (DF: the operand is contiguous
// in depth) RQ neighbouring threads take one 32-byte sector of a column
// and the next ones the next columns, so that a warp reads whole sectors
// and, rows kLd = 4 mod 32 words apart, writes distinct banks (distinct
// 8-byte pairs a half-warp for double).
template <typename T, bool DF>
struct SlicePos {
    static constexpr int RQ = DF ? 32 / (int)sizeof(T) : 1;
    static constexpr int CPT = kThreads / RQ;
    static constexpr int NC = DF ? kT / CPT : 1;
    static constexpr int N = kBK * kT / kThreads;
    static_assert(DF ? (kBK % RQ == 0 && kT % CPT == 0)
                     : kThreads % kT == 0,
                  "a slice is whole rows and columns");
    __device__ static constexpr int dr(int i) {
        return DF ? RQ * (i / NC) : (kThreads / kT) * i;
    }
    __device__ static constexpr int dc(int i) { return DF ? CPT * (i % NC) : 0; }
    int r, c;
    __device__ SlicePos() {
        const int t = (int)threadIdx.x;
        r = DF ? t % RQ : t / kT;
        c = DF ? t / RQ : t % kT;
    }
};

// dst[d kLd + c] = X(d0 + d, c) for d < kBK, c < kT, with X(d, c) =
// base[d ds + c cs] where d < dn, c < cn and c <= d + tri, else 0 (base
// is any readable address for the zeros).
template <typename T, bool DF>
__device__ __forceinline__ void load_slice(T* dst, const T* base, int64_t ds,
                                           int64_t cs, int d0, int dn, int cn,
                                           int tri) {
    using Pos = SlicePos<T, DF>;
    const Pos p;
    const T* src = base + (int64_t)(d0 + p.r) * ds + (int64_t)p.c * cs;
    T* to = dst + p.r * kLd + p.c;
    if (d0 + kBK <= dn && kT <= cn && kT - 1 <= d0 + tri) {
#pragma unroll
        for (int i = 0; i < Pos::N; ++i) {  // wholly inside: no tests
            cp_async_elem(to + Pos::dr(i) * kLd + Pos::dc(i),
                          src + Pos::dr(i) * ds + Pos::dc(i) * cs, true);
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < Pos::N; ++i) {
        const int d = d0 + p.r + Pos::dr(i), c = p.c + Pos::dc(i);
        const bool v = d < dn && c < cn && c <= d + tri;
        cp_async_elem(to + Pos::dr(i) * kLd + Pos::dc(i),
                      v ? src + Pos::dr(i) * ds + Pos::dc(i) * cs : base, v);
    }
}

// rows [r0, r0 + kBK) of a row-major 64 x 64 tile into dst's rows,
// 16-byte copies through L2
template <typename T>
__device__ __forceinline__ void load_tile_slice(T* dst, const T* tile,
                                                int r0) {
    constexpr int V = 16 / (int)sizeof(T);
    constexpr int N = kBK * kT / V / kThreads;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int e = ((int)threadIdx.x + i * kThreads) * V;
        cp_async_16(dst + (e / kT) * kLd + e % kT, tile + r0 * kT + e);
    }
}

// nq slices through the ring into the core: issue(q, slot) starts the
// copies of slice q into its slot.
template <class Core, class Issue>
__device__ __forceinline__ void run_ring(Core& core, typename Core::T* sm,
                                         int nq, Issue issue) {
#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nq) issue(s, sm + s * kSlot);
        cp_async_commit();
    }
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
        cp_async_wait<kStages - 2>();  // this thread's copies of slice q
        __syncthreads();  // every copy of q in; the slot of q - 1 free
        const int w = q + kStages - 1;
        if (w < nq) issue(w, sm + (w % kStages) * kSlot);
        cp_async_commit();
        const typename Core::T* x = sm + (q % kStages) * kSlot;
        core.compute(x, x + kBK * kLd);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
}

// S = 1/2 (G + G^T) on the pairs of the work list (work[2p], work[2p +
// 1]) = (a-tile, b-tile); persistent CTAs, one ticket a pair.
template <typename T, bool LCOL, bool GCOL>
__global__ void __launch_bounds__(kThreads)
vjp_tri_kernel(const T* __restrict__ L, const T* __restrict__ Lb,
               T* __restrict__ S, int n, const int* __restrict__ work,
               int nwork, int* ticket) {
    extern __shared__ __align__(16) unsigned char vjp_smem[];
    T* sm = reinterpret_cast<T*>(vjp_smem);
    __shared__ int s_item;
    // X(k, c) = X[k ds + c cs] for either storage order
    const int64_t lds = LCOL ? 1 : n, lcs = LCOL ? n : 1;
    const int64_t gds = GCOL ? 1 : n, gcs = GCOL ? n : 1;
#pragma unroll 1
    for (;;) {
        if (threadIdx.x == 0) s_item = atomicAdd(ticket, 1);
        __syncthreads();
        const int p = s_item;
        if (p >= nwork) break;
        const int a0 = work[2 * p] * kT, b0 = work[2 * p + 1] * kT;
        typename CoreOf<T>::type core;
        core.zero();
        const T* La = L + a0 * lcs;
        const T* Gb = Lb + b0 * gcs;
        // rows k from the a-tile's first: L[k, a] is 0 for k < a
        run_ring(core, sm, (n - a0 + kBK - 1) / kBK, [&](int q, T* x) {
            const int k0 = a0 + q * kBK;
            load_slice<T, LCOL>(x, La, lds, lcs, k0, n, n - a0, -a0);
            load_slice<T, GCOL>(x + kBK * kLd, Gb, gds, gcs, k0, n, n - b0,
                                -b0);
        });
        core.each([&](int r, int c, T& v) { sm[r * kEld + c] = T(0.5) * v; });
        __syncthreads();
        // S[a, b] for a >= b (the diagonal tile's upper half is not G's),
        // row by row, then the mirror S[b, a], a > b, column by column
        const bool diag = a0 == b0;
        for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) {
            const bool mirror = e >= kTile;
            const int f = mirror ? e - kTile : e;
            const int r = mirror ? f % kT : f / kT;
            const int c = mirror ? f / kT : f % kT;
            const int a = a0 + r, b = b0 + c;
            if (a >= n || b >= n || (diag && (mirror ? c >= r : c > r))) {
                continue;
            }
            const T v = sm[r * kEld + c];
            if (mirror) {
                S[(int64_t)b * n + a] = v;
            } else {
                S[(int64_t)a * n + b] = v;
            }
        }
        __syncthreads();
    }
}

// Route 1: a thread an entry (a, b), a >= b, k ascending from a.
template <typename T, bool LCOL, bool GCOL>
__global__ void __launch_bounds__(kSeq * kSeq)
vjp_tri_seq_kernel(const T* __restrict__ L, const T* __restrict__ Lb,
                   T* __restrict__ S, int n) {
    const int b = blockIdx.x * kSeq + threadIdx.x;
    const int a = blockIdx.y * kSeq + threadIdx.y;
    if (a >= n || b > a) return;
    T acc = T(0);
    for (int k = a; k < n; ++k) {
        const T l = LCOL ? L[(int64_t)a * n + k] : L[(int64_t)k * n + a];
        const T g = GCOL ? Lb[(int64_t)b * n + k] : Lb[(int64_t)k * n + b];
        acc = madd(l, g, acc);
    }
    const T v = T(0.5) * acc;
    S[(int64_t)a * n + b] = v;
    S[(int64_t)b * n + a] = v;
}

// L's lower tiles into their packed tiles, tile p = blockIdx.x = (J, I)
// at p kTile, row k, column i at k kT + i: -L_JI off the diagonal (the
// coupling products add), L_II on it (zero above its diagonal); zero past
// n. Read along L's contiguous dimension, written through shared memory.
template <typename T, bool COL>
__global__ void __launch_bounds__(kPackThreads)
vjp_pack_kernel(const T* __restrict__ L, T* __restrict__ Lp, int n) {
    __shared__ T t[kT][kEld];
    int J, I;
    pair_of((int64_t)blockIdx.x, J, I);
    const int J0 = J * kT, I0 = I * kT;
    const int64_t rs = COL ? 1 : n, cs = COL ? n : 1;
    const T sign = J == I ? T(1) : T(-1);
    for (int e = threadIdx.x; e < kTile; e += kPackThreads) {
        const int k = COL ? e % kT : e / kT, i = COL ? e / kT : e % kT;
        const int gk = J0 + k, gi = I0 + i;
        t[k][i] = (gk < n && gi < n && gi <= gk)
                      ? sign * L[(int64_t)gk * rs + (int64_t)gi * cs]
                      : T(0);
    }
    __syncthreads();
    T* out = Lp + (int64_t)blockIdx.x * kTile;
    for (int e = threadIdx.x; e < kTile; e += kPackThreads) {
        out[e] = t[e / kT][e % kT];
    }
}

// Four consecutive values of a row in shared memory (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
}

// The ring slot that holds row k of L_II (X part) and of R (Y part): the
// last rows first, the order the substitution reads them.
__host__ __device__ constexpr int slot_of_row(int k) {
    return kSub - 1 - k / kBK;
}

// 1 / L_kk for k in [k0, k0 + n) (0 past r), n threads.
template <typename T>
__device__ __forceinline__ void pivots(const T* sm, T* inv, int k0, int n,
                                       int r) {
    if ((int)threadIdx.x < n) {
        const int k = k0 + threadIdx.x;
        inv[k] = k < r ? T(1) / sm[slot_of_row(k) * kSlot + (k % kBK) * kLd +
                                   k]
                       : T(0);
    }
}

// Step K (descending) of the block substitution below: y_K = R_K / L_KK
// from the lane that holds row K, then R_m -= L_Km y_K for the thread's
// rows m < K. K is a template parameter, so every index into y is a
// constant and y stays in registers. L_II's first kBK rows are copied
// last: step kBK - 1 waits for them.
template <typename T, int K>
struct SolveStep {
    __device__ __forceinline__ static void run(T (&y)[kT / 2], const T* sm,
                                               T* inv, int r, int h,
                                               int lane) {
        if (K == kBK - 1) {
            cp_async_wait<0>();
            __syncthreads();
            pivots(sm, inv, 0, kBK, r);
            __syncthreads();
        }
        constexpr int own = (K / 4) % 2, idx = 4 * (K / 8) + K % 4;
        const T yk = __shfl_sync(0xffffffffu, y[idx] * inv[K],
                                 (lane & ~1) | own);
        if (h == own) y[idx] = yk;
        const T* lk = sm + slot_of_row(K) * kSlot + (K % kBK) * kLd;
#pragma unroll
        for (int g = 0; g < (K + 7) / 8; ++g) {
            const int m0 = 8 * g + 4 * h;
            if (m0 < K) {
                T l[4];
                load4(lk + m0, l);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (m0 + q < K) y[4 * g + q] = madd(-l[q], yk, y[4 * g + q]);
                }
            }
        }
        SolveStep<T, K - 1>::run(y, sm, inv, r, h, lane);
    }
};
template <typename T>
struct SolveStep<T, -1> {
    __device__ __forceinline__ static void run(T (&)[kT / 2], const T*, T*,
                                               int, int, int) {}
};

// The block substitution L_II^T Y_I = R: R's rows in the four slots' Y
// parts and L_II's in their X parts (row k in slot slot_of_row(k), row k
// % kBK; all but L_II's first kBK rows in). Column j of R is two lanes
// of one warp; lane h holds rows 8 g +
// 4 h + q (q < 4) in y[4 g + q], so that it reads L's rows in 16-byte
// pieces. Right-looking, k descending: y_k = R_k / L_kk (a reciprocal
// pivot), then R_m -= L_km y_k for m < k; rows past r have a zero pivot
// and stay zero.
template <typename T>
__device__ __forceinline__ void solve_block(const T* sm, T* inv, int r,
                                            T (&y)[kT / 2]) {
    const int j = (int)threadIdx.x / 2, h = (int)threadIdx.x % 2;
    pivots(sm, inv, kBK, kT - kBK, r);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) {
        const int m = 8 * (i / 4) + 4 * h + i % 4;
        y[i] = sm[slot_of_row(m) * kSlot + (kBK + m % kBK) * kLd + j];
    }
    __syncthreads();
    SolveStep<T, kT - 1>::run(y, sm, inv, r, h, (int)threadIdx.x % 32);
}

// The substitutions (see the head of the file). flags: Y's nb x nb
// release flags, X's, then the ticket; Y nb x nb tiles, Z (X's lower
// block triangle) and Lp packed, tile (J, I) at tri_index(J, I).
template <typename T>
__global__ void __launch_bounds__(kThreads)
vjp_solve_kernel(const T* __restrict__ S, T* __restrict__ X,
                 const T* __restrict__ Lp, T* Y, T* Z, int* flags,
                 const int* __restrict__ work, int n, int nb) {
    extern __shared__ __align__(16) unsigned char vjp_smem[];
    T* sm = reinterpret_cast<T*>(vjp_smem);
    __shared__ int s_item, s_ok;
    __shared__ T s_inv[kT];
    int* const yflag = flags;
    int* const zflag = flags + nb * nb;
    if (threadIdx.x == 0) s_item = atomicAdd(flags + 2 * nb * nb, 1);
    __syncthreads();
    const int item = s_item;
    const int stage = work[3 * item], I = work[3 * item + 1];
    const int c = work[3 * item + 2];
    const int I0 = I * kT, c0 = c * kT;
    typename CoreOf<T>::type core;
    core.zero();

    // the right-hand side: S[I0 + r][c0 + j] (stage 0), or Y[c0 + j][I0 +
    // r] (stage 1, transposed through shared memory)
    if (stage == 0) {
        core.each([&](int r, int j, T& v) {
            const int gr = I0 + r, gc = c0 + j;
            v = (gr < n && gc < n) ? S[(int64_t)gr * n + gc] : T(0);
        });
    } else {
        wait_flag(yflag + c * nb + I);
        const T* yt = Y + ((int64_t)c * nb + I) * kTile;
        for (int e = threadIdx.x; e < kTile; e += kThreads) {
            sm[(e / kT) * kEld + e % kT] = __ldcg(yt + e);
        }
        __syncthreads();
        core.each([&](int r, int j, T& v) { v = sm[j * kEld + r]; });
        __syncthreads();
    }
    core.flush();

    // the coupling products, then L_II: slice q < nq is rows (q % kSub)
    // kBK.. of block J = nb - 1 - q / kSub (-L_JI's and Y's or X's tile
    // (J, c)); slice nq + s is L_II's rows in slot s (X parts only; nq is
    // a multiple of kSub)
    const int nq = kSub * (nb - 1 - I);
    int* const fl = stage == 0 ? yflag : zflag;
    const T* const src = stage == 0 ? Y : Z;
    auto flag_of = [&](int q) { return fl + (nb - 1 - q / kSub) * nb + c; };
    auto issue = [&](int q) {
        T* x = sm + (q % kStages) * kSlot;
        if (q < nq) {
            const int J = nb - 1 - q / kSub, r0 = (q % kSub) * kBK;
            const int64_t tj =
                stage == 0 ? (int64_t)J * nb + c : tri_index(J, c);
            load_tile_slice(x, Lp + tri_index(J, I) * kTile, r0);
            load_tile_slice(x + kBK * kLd, src + tj * kTile, r0);
        } else {
            // L_II's rows in the order the substitution reads them
            load_tile_slice(x, Lp + tri_index(I, I) * kTile,
                            (kSub - 1 - (q - nq)) * kBK);
        }
        cp_async_commit();
    };
    int issued = 0;  // slices issued, one commit group each
    // issues the slices before ``limit`` while their blocks are published;
    // the window never holds two block starts, so one probe (and s_ok is
    // read by all before the next probe, behind the loop's barrier)
    auto ahead = [&](int limit) {
        while (issued < nq + kSub && issued < limit) {
            if (issued < nq && issued % kSub == 0) {
                if (threadIdx.x == 0) s_ok = load_acquire(flag_of(issued));
                __syncthreads();
                if (!s_ok) break;
            }
            issue(issued);
            ++issued;
        }
    };
    __syncthreads();  // the right-hand side is out of the slots
    ahead(kStages);
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
        if (issued == q) {  // the ring ran dry: q starts an unpublished block
            wait_flag(flag_of(q));
            issue(q);
            ++issued;
        }
        cp_async_wait_dyn(issued - 1 - q);
        __syncthreads();  // slice q in; the slot of q - 1 free
        ahead(q + kStages);
        const T* x = sm + (q % kStages) * kSlot;
        core.compute(x, x + kBK * kLd);
        if (q % kSub == kSub - 1) core.flush();  // a block's product in
    }
    core.settle();
    __syncthreads();  // every slot is read
    ahead(nq + kSub);
    core.each([&](int r, int j, T& v) {
        sm[slot_of_row(r) * kSlot + (kBK + r % kBK) * kLd + j] = v;
    });
    cp_async_wait<1>();  // all but L_II's first rows, the newest copies
    __syncthreads();
    T y[kT / 2];
    solve_block(sm, s_inv, min(kT, n - I0), y);

    // Y's tile, or X's (its lower block triangle kept for the later
    // blocks) and A-bar's entries with their mirrors
    const int j = (int)threadIdx.x / 2, h = (int)threadIdx.x % 2;
    auto row_of = [&](int i) { return 8 * (i / 4) + 4 * h + i % 4; };
    if (stage == 0 || I > c) {
        T* out = stage == 0 ? Y + ((int64_t)I * nb + c) * kTile
                            : Z + tri_index(I, c) * kTile;
#pragma unroll
        for (int i = 0; i < kT / 2; ++i) out[row_of(i) * kT + j] = y[i];
        publish(stage == 0 ? yflag + I * nb + c : zflag + I * nb + c);
        if (stage == 0) return;
    }
    __syncthreads();  // the slots are read
#pragma unroll
    for (int i = 0; i < kT / 2; ++i) sm[row_of(i) * kEld + j] = y[i];
    __syncthreads();
    // A-bar's block (I, c) row by row, then its mirror column by column;
    // on the diagonal block the lower half and its mirror
    const bool diag = I == c;
    for (int e = threadIdx.x; e < 2 * kTile; e += kThreads) {
        const bool mirror = e >= kTile;
        const int f = mirror ? e - kTile : e;
        const int r = mirror ? f % kT : f / kT;
        const int jj = mirror ? f / kT : f % kT;
        const int a = I0 + r, b = c0 + jj;
        if (a >= n || b >= n || (diag && (mirror ? jj >= r : jj > r))) {
            continue;
        }
        const T v = sm[r * kEld + jj];
        if (mirror) {
            X[(int64_t)b * n + a] = v;
        } else {
            X[(int64_t)a * n + b] = v;
        }
    }
}

std::mutex& launch_lock() {
    static std::mutex lock;
    return lock;
}

// The shared-memory opt-in of ``kern`` and the CTAs co-resident on the
// device (``capacity``): once per device and kernel (``facts`` is the
// kernel's own table).
template <typename K>
int prepare(K kern, size_t smem, int* facts, int* capacity) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(launch_lock());
    if (facts[dev] == 0) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        int nsm = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                            kThreads, smem);
        if (err != cudaSuccess) return (int)err;
        facts[dev] = (per_sm > 0 ? per_sm : 1) * nsm;
    }
    *capacity = facts[dev];
    return 0;
}

template <typename T, bool LCOL, bool GCOL>
int launch_tri(const T* L, const T* Lb, T* S, int n, const int* work,
               int nwork, int* ticket, int route, cudaStream_t st) {
    if (route == 1) {
        const unsigned nt = (unsigned)((n + kSeq - 1) / kSeq);
        vjp_tri_seq_kernel<T, LCOL, GCOL>
            <<<dim3(nt, nt), dim3(kSeq, kSeq), 0, st>>>(L, Lb, S, n);
        return (int)cudaGetLastError();
    }
    constexpr size_t smem = ring_bytes<T>();
    static int facts[kMaxDevices] = {};
    int capacity = 0;
    const int rc = prepare(vjp_tri_kernel<T, LCOL, GCOL>, smem, facts,
                           &capacity);
    if (rc != 0) return rc;
    cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const int grid = nwork < capacity ? nwork : capacity;
    vjp_tri_kernel<T, LCOL, GCOL><<<grid, kThreads, smem, st>>>(
        L, Lb, S, n, work, nwork, ticket);
    return (int)cudaGetLastError();
}

template <typename T>
int tri(const T* L, int lcol, const T* Lb, int gcol, T* S, int64_t n,
        const int* work, int nwork, int* ticket, int route, void* stream) {
    if (n < 0 || n > 0x7fffffff / 2 || (route != 0 && route != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return (int)cudaGetLastError();
    const int ni = (int)n, nb = (ni + kT - 1) / kT;
    if (route == 0 && (int64_t)nwork != tri_index(nb, 0)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    if (lcol && gcol) {
        return launch_tri<T, true, true>(L, Lb, S, ni, work, nwork, ticket,
                                         route, st);
    }
    if (lcol) {
        return launch_tri<T, true, false>(L, Lb, S, ni, work, nwork, ticket,
                                          route, st);
    }
    if (gcol) {
        return launch_tri<T, false, true>(L, Lb, S, ni, work, nwork, ticket,
                                          route, st);
    }
    return launch_tri<T, false, false>(L, Lb, S, ni, work, nwork, ticket,
                                       route, st);
}

template <typename T, bool COL>
int launch_pack(const T* L, T* Lp, int n, int nb, cudaStream_t st) {
    vjp_pack_kernel<T, COL><<<(unsigned)tri_index(nb, 0), kPackThreads, 0,
                              st>>>(L, Lp, n);
    return (int)cudaGetLastError();
}

// scratch: Lp and Z (tri_index(nb, 0) tiles each), then Y (nb * nb
// tiles); flags: 2 nb^2 + 1 ints; work: nb^2 + tri_index(nb, 0) items.
template <typename T>
int solve(const T* L, int lcol, const T* S, T* X, T* scratch, int* flags,
          const int* work, int nwork, int64_t n, void* stream) {
    if (n < 0 || n > 0x7fffffff / 2) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int ni = (int)n, nb = (ni + kT - 1) / kT;
    const int64_t ntri = tri_index(nb, 0);
    if ((int64_t)nwork != (int64_t)nb * nb + ntri) {
        return (int)cudaErrorInvalidValue;
    }
    T* Lp = scratch;
    T* Z = Lp + ntri * kTile;
    T* Y = Z + ntri * kTile;
    cudaStream_t st = (cudaStream_t)stream;
    int rc = lcol ? launch_pack<T, true>(L, Lp, ni, nb, st)
                  : launch_pack<T, false>(L, Lp, ni, nb, st);
    if (rc != 0) return rc;
    constexpr size_t smem = ring_bytes<T>();
    static int facts[kMaxDevices] = {};
    int capacity = 0;
    rc = prepare(vjp_solve_kernel<T>, smem, facts, &capacity);
    if (rc != 0) return rc;
    cudaError_t err = cudaMemsetAsync(
        flags, 0, sizeof(int) * ((size_t)2 * nb * nb + 1), st);
    if (err != cudaSuccess) return (int)err;
    vjp_solve_kernel<T><<<(unsigned)nwork, kThreads, smem, st>>>(
        S, X, Lp, Y, Z, flags, work, ni, nb);
    return (int)cudaGetLastError();
}

}  // namespace

#define CHOL_VJP_ENTRIES(T, SFX)                                              \
    extern "C" int chol_vjp_tri_##SFX(const T* L, int lcol, const T* Lb,      \
                                      int gcol, T* S, int64_t n,              \
                                      const int* work, int nwork,             \
                                      int* ticket, int route, void* stream) { \
        return tri<T>(L, lcol, Lb, gcol, S, n, work, nwork, ticket, route,    \
                      stream);                                                \
    }                                                                         \
    extern "C" int chol_vjp_solve_##SFX(const T* L, int lcol, const T* S,     \
                                        T* X, T* scratch, int* flags,         \
                                        const int* work, int nwork,           \
                                        int64_t n, void* stream) {            \
        return solve<T>(L, lcol, S, X, scratch, flags, work, nwork, n,        \
                        stream);                                              \
    }

CHOL_VJP_ENTRIES(float, f32)
CHOL_VJP_ENTRIES(double, f64)
