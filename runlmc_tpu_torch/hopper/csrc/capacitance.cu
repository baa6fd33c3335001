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
// What is skipped: F_{g,d} is zero past column (d+1) m_g (F is lower
// triangular), G_{ab,d} is zero outside a few tiles per row block (the
// host lists the nonzero tiles once per grid), and C is symmetric. The
// operation count falls from 2 D m^2 Dm + 2 Dm^3 to about m^3 sum_d d^2
// (5.3x fewer at the weather twin's D = 4, m = 2504). What bounds it on
// the card: operations, on FFMA at 67 TFLOP/s in float32 (TF32 stays
// off) and on the FP64 tensor cores (DMMA) at 67 TFLOP/s in float64.
//
// Stage 1 (gram_apply): T_{ab,d} = G_{ab,d} F_{b,d}, a 64 x 64 output
//   tile per CTA, its depth the nonzero 64 x 16 tiles of G_{ab,d} in the
//   host plan, zero column tiles of F skipped.
// Stage 2 (cap): C's 64 x 64 lower tiles, from a host work list sorted
//   deepest first (a tile row's depth is sum_d (m_a - imin_d) rows):
//   persistent CTAs, as many as are co-resident, take the next tile from
//   an atomic ticket. Each tile loops over the d whose F_{a,d} reaches
//   it, d ascending, and over the rows i of F_{a,d} that are nonzero
//   there, with eps_d^-1 applied to F's slice in shared memory; it adds
//   I and writes the tile and its mirror through shared memory, both
//   coalesced.
// Backward: S = Cbar + Cbar^T in one tiled pass (cap_sym: both reads
//   coalesced); cap_bwd on the 64 x 64 tiles of each F_{a,d} that reach
//   its lower triangle, from a work list sorted deepest first (depth
//   sum_g min(k_g, (d+1) m_g)) like stage 2's: Y_{a,d} = T_{a.,d} S[:, a]
//   into Fbar's buffer; cap_bwd_finish on its 128 x 128 tiles: Fbar_{a,d}
//   = eps_d^-1 Y_{a,d} on F's lower triangle (0 above: a Cholesky
//   backward reads only the lower one) and each tile's sum of
//   <F_{a,d}, Y_{a,d}>; eps_reduce adds those in a fixed order into
//   d(eps_d^-1) = 1/2 sum_a <F_{a,d}, Y_{a,d}>.
//
// The core, shared by stage 1, stage 2 and cap_bwd: a ring of kStages
// slices of both operands in dynamic shared memory, filled by cp.async
// (one element per copy: F's rows are not 16-byte aligned at the paths'
// k, and the copy zero-fills what lies outside the matrix or above F's
// diagonal), one barrier per slice. Neighbouring threads copy
// neighbouring addresses in either storage order of F (row-major, or
// column-major as cuSOLVER leaves it, which the paths pass), without
// shared-memory bank conflicts. Float32 (FmaCore): each thread keeps a
// TM x TN register tile fed by 16-byte shared-memory loads. Float64
// (MmaCore): each warp keeps a grid of 16 x 8 tiles on
// mma.sync.m16n8k8.f64 (DMMA).
//
// Sum order. Every output element is one thread's own sum (or one
// warp's mma chain) in a fixed order: no atomics, no split of a sum
// across CTAs, the same bits on every run and whichever CTA takes a
// tile. Float32 keeps the bits of the earlier one-CTA-per-tile kernel,
// whose order does not depend on the tile shape chosen here: stage 1
// sums r ascending in one register; stage 2 sums d ascending, i
// ascending from imin_d = max(0, k0 - d m_a) with k0 the entry's
// 128-row block (kAnchor), and adds the register sum into a running
// total after each 128 rows counted from imin_d (kRunTerms; only where
// the 8-row slice that closes them starts before m_a, else the rows run
// on into the next d); the backward likewise over each group's rows,
// groups ascending, and sums the d(eps^-1) partials per 128 x 128 tile
// in the earlier kernel's thread order and tree (so the partials have a
// pass of their own). Float64 rounds apart from the earlier kernel
// (DMMA's order within k = 8), the same on every run.
//
// Limit that raises: at most Groups::kMax (8) groups in a backward (the
// wrapper checks it first).

#include <climits>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kPlanRows = 64;  // rows of a plan tile of G (stage-1 tile)
constexpr int kPlanCols = 16;  // columns of a plan tile of G
constexpr int kStages = 3;     // slices in flight in the ring
constexpr int kRunTerms = 128;  // rows a register sum takes (float32)
constexpr int kRunSlice = 8;    // ... counted in slices of this many rows
constexpr int kAnchor = 128;    // stage 2's float32 rows start per 128
constexpr int kBwdTile = 128;   // the d(eps^-1) partials' tile
constexpr int kBwdThreads = 256;
constexpr int kNoTri = INT_MAX / 2;
constexpr int kMaxDevices = 16;

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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// a * b + c, rounded once (FFMA / DFMA)
__device__ __forceinline__ float madd(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
    return fma(a, b, c);
}

// The elements of a BK x W slice that this thread copies: the i-th at
// (r + dr(i), c + dc(i)). Along the tile (the operand contiguous in c),
// neighbouring threads take neighbouring columns. Along the depth (the
// operand contiguous in r), RQ neighbouring threads take one 32-byte
// sector of a column and the next ones the next columns, so that a
// warp reads whole sectors and, with rows LD = 4 mod 32 words apart,
// writes 32 distinct banks (16 distinct 8-byte pairs per half-warp for
// double).
template <typename T, int BK, int W, int NT, bool DEPTH_FAST>
struct SlicePos {
    static constexpr int RQ = 32 / (int)sizeof(T);
    static constexpr int CPT = NT / RQ, NC = W / CPT;
    static_assert(NT % W == 0 && (BK * W) % NT == 0 && BK % RQ == 0 &&
                  W % CPT == 0, "a slice is whole rows and columns");
    static constexpr int N = BK * W / NT;
    __host__ __device__ static constexpr int dr(int i) {
        return DEPTH_FAST ? RQ * (i / NC) : (NT / W) * i;
    }
    __host__ __device__ static constexpr int dc(int i) {
        return DEPTH_FAST ? CPT * (i % NC) : 0;
    }
    int r, c;
    __device__ SlicePos() {
        const int t = (int)threadIdx.x;
        r = DEPTH_FAST ? t % RQ : t / W;
        c = DEPTH_FAST ? t / RQ : t % W;
    }
};

// A BK x W slice into dst[r * LD + c]: element (r0 + r, c) of the operand
// at base[(r0 + r) rs + c cs], zero where r0 + r >= rend, c >= nc or
// c - (r0 + r) > tri (above F's diagonal); ``safe`` is any readable
// address, named by the copies that write zero. A slice wholly inside
// (most of them) is copied without a test per element.
template <typename T, int BK, int W, int LD, int NT, bool DEPTH_FAST>
__device__ __forceinline__ void load_slice(T* dst, const T* base,
                                           const T* safe, int64_t rs,
                                           int64_t cs, int r0, int rend,
                                           int nc, int tri) {
    using Pos = SlicePos<T, BK, W, NT, DEPTH_FAST>;
    const Pos q;
    const T* src = base + (int64_t)(r0 + q.r) * rs + (int64_t)q.c * cs;
    T* to = dst + q.r * LD + q.c;
    if (r0 + BK <= rend && W <= nc && W - 1 - r0 <= tri) {
#pragma unroll
        for (int i = 0; i < Pos::N; ++i) {
            cp_async_elem(to + Pos::dr(i) * LD + Pos::dc(i),
                          src + Pos::dr(i) * rs + Pos::dc(i) * cs, true);
        }
        return;
    }
#pragma unroll
    for (int i = 0; i < Pos::N; ++i) {
        const int rr = r0 + q.r + Pos::dr(i), c = q.c + Pos::dc(i);
        const bool v = rr < rend && c < nc && c - rr <= tri;
        cp_async_elem(to + Pos::dr(i) * LD + Pos::dc(i),
                      v ? src + Pos::dr(i) * rs + Pos::dc(i) * cs : safe, v);
    }
}

// s times the elements of a slice that this thread copied (after its own
// copies landed): the same product s * F as a scale in the load.
template <typename T, int BK, int W, int LD, int NT, bool DEPTH_FAST>
__device__ __forceinline__ void scale_slice(T* dst, T s) {
    using Pos = SlicePos<T, BK, W, NT, DEPTH_FAST>;
    const Pos q;
    T* to = dst + q.r * LD + q.c;
#pragma unroll
    for (int i = 0; i < Pos::N; ++i) {
        T& x = to[Pos::dr(i) * LD + Pos::dc(i)];
        x = s * x;
    }
}

// Float32: a (BM / TM) x (BN / TN) grid of threads, each with a TM x TN
// register sum ``acc`` and its running total ``tot``. Thread (tx, ty)
// holds rows (i / 4) (BM / RM) + 4 ty + i % 4 and the like columns, so
// that its operands come in 16-byte loads.
template <int BM_, int BN_, int TM, int TN, int BK_>
struct FmaCore {
    using T = float;
    static constexpr int BM = BM_, BN = BN_, BK = BK_;
    static constexpr int NTX = BN / TN, NTY = BM / TM, NT = NTX * NTY;
    static constexpr int LDX = BM + 4, LDY = BN + 4;
    static constexpr int RM = TM / 4, RN = TN / 4;
    static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles of 4");
    float acc[TM][TN], tot[TM][TN];
    int tx, ty;

    __device__ FmaCore()
        : tx((int)threadIdx.x % NTX), ty((int)threadIdx.x / NTX) {}
    __device__ int row(int i) const {
        return (i / 4) * (NTY * 4) + ty * 4 + i % 4;
    }
    __device__ int col(int j) const {
        return (j / 4) * (NTX * 4) + tx * 4 + j % 4;
    }
    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = tot[i][j] = 0.f;
    }
    __device__ void compute(const float* sx, const float* sy) {
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const float4 v = *reinterpret_cast<const float4*>(
                    sx + k * LDX + i * (NTY * 4) + ty * 4);
                a[4 * i] = v.x;
                a[4 * i + 1] = v.y;
                a[4 * i + 2] = v.z;
                a[4 * i + 3] = v.w;
            }
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const float4 v = *reinterpret_cast<const float4*>(
                    sy + k * LDY + j * (NTX * 4) + tx * 4);
                b[4 * j] = v.x;
                b[4 * j + 1] = v.y;
                b[4 * j + 2] = v.z;
                b[4 * j + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = madd(a[i], b[j], acc[i][j]);
        }
    }
    // the running total takes the register sum
    __device__ void flush() {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                tot[i][j] += acc[i][j];
                acc[i][j] = 0.f;
            }
    }
    __device__ void finish() { flush(); }
    __device__ void store(float* out, int ldo) const {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) out[row(i) * ldo + col(j)] = tot[i][j];
    }
};

// Float64: WM x WN warps, each a (BM / WM) x (BN / WN) warp tile of
// 16 x 8 DMMA tiles, mma.sync.aligned.m16n8k8.row.col.f64 (with g = l / 4
// and t = l % 4 for lane l, a_i holds A[g + 8 (i % 2)][t + 4 (i / 2)],
// b_i B[t + 4 i][g], c_i C[g + 8 (i / 2)][2 t + i % 2]). On the H100 this
// shape runs at the FP64 tensor peak; m8n8k4 runs at half of it. The
// shared-memory rows are BM + 4 doubles apart (4 mod 16), so a
// fragment's 32 loads fall on distinct banks.
template <int BM_, int BN_, int WM, int WN, int BK_>
struct MmaCore {
    using T = double;
    static constexpr int BM = BM_, BN = BN_, BK = BK_;
    static constexpr int NT = WM * WN * 32;
    static constexpr int TWM = BM / WM, TWN = BN / WN;
    static constexpr int MI = TWM / 16, NI = TWN / 8;
    static constexpr int LDX = BM + 4, LDY = BN + 4;
    static_assert(BK % 8 == 0 && TWM % 16 == 0 && TWN % 8 == 0,
                  "DMMA tiles");
    double acc[MI][NI][4];
    int g, t, wm0, wn0;

    __device__ MmaCore() {
        const int lane = (int)threadIdx.x % 32, w = (int)threadIdx.x / 32;
        g = lane / 4;
        t = lane % 4;
        wm0 = (w / WN) * TWM;
        wn0 = (w % WN) * TWN;
    }
    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
    }
    __device__ void compute(const double* sx, const double* sy) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 8) {
            double a[MI][4], b[NI][2];
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    a[i][q] = sx[(kk + t + 4 * (q / 2)) * LDX + wm0 + i * 16 +
                                 g + 8 * (q % 2)];
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
                for (int q = 0; q < 2; ++q)
                    b[j][q] = sy[(kk + t + 4 * q) * LDY + wn0 + j * 8 + g];
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int j = 0; j < NI; ++j)
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
    __device__ void flush() {}
    __device__ void finish() {}
    __device__ void store(double* out, int ldo) const {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    out[(wm0 + i * 16 + g + 8 * (q / 2)) * ldo + wn0 + j * 8 +
                        2 * t + q % 2] = acc[i][j][q];
    }
};

// Dynamic shared memory of a CTA: the ring, or the output tile of the
// epilogue, whichever is larger (they take turns).
template <class Core>
constexpr size_t smem_bytes() {
    using T = typename Core::T;
    constexpr size_t ring = sizeof(T) * kStages * Core::BK *
                            (size_t)(Core::LDX + Core::LDY);
    constexpr size_t tile = sizeof(T) * Core::BM * (size_t)(Core::BN + 1);
    return ring > tile ? ring : tile;
}

// One output tile: the plan's slices through the ring into the core.
// A plan names its slices with a cursor: begin / next step it, issue
// starts a slice's copies, fix runs after the thread's own copies of it
// landed, flush_after says whether the register sum goes into the
// running total after it.
template <class Core, class Plan>
__device__ void run_tile(Core& core, typename Core::T* smem,
                         const Plan& plan) {
    using T = typename Core::T;
    constexpr int XS = Core::BK * Core::LDX, YS = Core::BK * Core::LDY;
    core.zero();
    typename Plan::Cursor lc, cc;
    bool lok = plan.begin(lc);
    bool cok = lok;
    cc = lc;
#pragma unroll 1
    for (int s = 0; s < kStages - 1; ++s) {
        if (lok) {
            T* x = smem + s * (XS + YS);
            plan.issue(lc, x, x + XS);
            lok = plan.next(lc);
        }
        cp_async_commit();
    }
    int cs = 0, ws = kStages - 1;
#pragma unroll 1
    while (cok) {
        cp_async_wait<kStages - 2>();  // this thread's copies of slice cc
        T* x = smem + cs * (XS + YS);
        plan.fix(cc, x);
        __syncthreads();  // every copy of cc in; slot ws read by all
        if (lok) {
            T* w = smem + ws * (XS + YS);
            plan.issue(lc, w, w + XS);
            lok = plan.next(lc);
        }
        cp_async_commit();
        core.compute(x, x + XS);
        if (plan.flush_after(cc)) core.flush();
        cok = plan.next(cc);
        cs = cs + 1 == kStages ? 0 : cs + 1;
        ws = ws + 1 == kStages ? 0 : ws + 1;
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the epilogue
    core.finish();
}

// Stage 1's slices: the plan tiles e in [lo, hi) of the row block, rows
// [max(16 rblk[e], rmin), min(16 rblk[e] + 16, m_b)); X(r, p) =
// G_d[p0 + p][r], Y(r, q) = F_b[d m_b + r][q0 + q] (0 above F's
// diagonal).
template <class Core>
struct GramPlan {
    using T = typename Core::T;
    static_assert(Core::BK == kPlanCols && Core::BM == kPlanRows &&
                  Core::BN == kPlanRows, "stage 1 runs on plan tiles");
    const T *G, *Gx, *F, *Fy;
    int64_t fsr, fsc;
    const int* rblk;
    int lo, hi, mb, rmin, pn, qn, tri;
    struct Cursor { int e, r, re; };

    __device__ bool seek(Cursor& c) const {
        for (; c.e < hi; ++c.e) {
            const int rs = max(rblk[c.e] * kPlanCols, rmin);
            const int re = min(rblk[c.e] * kPlanCols + kPlanCols, mb);
            if (rs < re) {
                c.r = rs;
                c.re = re;
                return true;
            }
        }
        return false;
    }
    __device__ bool begin(Cursor& c) const {
        c.e = lo;
        return seek(c);
    }
    __device__ bool next(Cursor& c) const {
        ++c.e;
        return seek(c);
    }
    __device__ void issue(const Cursor& c, T* sx, T* sy) const {
        load_slice<T, Core::BK, Core::BM, Core::LDX, Core::NT, true>(
            sx, Gx, G, 1, mb, c.r, c.re, pn, kNoTri);
        if (fsr == 1) {
            load_slice<T, Core::BK, Core::BN, Core::LDY, Core::NT, true>(
                sy, Fy, F, fsr, fsc, c.r, c.re, qn, tri);
        } else {
            load_slice<T, Core::BK, Core::BN, Core::LDY, Core::NT, false>(
                sy, Fy, F, fsr, fsc, c.r, c.re, qn, tri);
        }
    }
    __device__ void fix(const Cursor&, T*) const {}
    __device__ bool flush_after(const Cursor&) const { return false; }
};

// Stage 2's slices: d ascending from anchor / m_a, rows from imin_d =
// max(0, anchor - d m_a) in slices of BK; X(i, c) = eps_d^-1 F_a[d m_a +
// i][k0 + c] (0 above F's diagonal), Y(i, c) = T_a[d][i][offb + l0 + c].
// With RUNS, the register sum goes into the running total after each
// kRunTerms rows counted from imin_d, where the kRunSlice-row slice that
// ends them starts before m_a.
template <class Core, bool RUNS>
struct CapPlan {
    using T = typename Core::T;
    static_assert(!RUNS || kRunTerms % Core::BK == 0, "runs of whole slices");
    const T *F, *T_;
    int64_t fsr, fsc, ldt;
    const T* inv_eps;
    int ma, D, ka, kb, k0, l0, offb, anchor;
    struct Cursor { int d, r, imin; };

    __device__ void start(Cursor& c) const {
        c.imin = max(0, anchor - c.d * ma);
        c.r = c.imin;
    }
    __device__ bool begin(Cursor& c) const {
        c.d = anchor / ma;
        start(c);
        return c.d < D;
    }
    __device__ bool next(Cursor& c) const {
        c.r += Core::BK;
        if (c.r >= ma) {
            if (++c.d >= D) return false;
            start(c);
        }
        return true;
    }
    __device__ void issue(const Cursor& c, T* sx, T* sy) const {
        const T* Fd = F + (int64_t)c.d * ma * fsr + (int64_t)k0 * fsc;
        if (fsr == 1) {
            load_slice<T, Core::BK, Core::BM, Core::LDX, Core::NT, true>(
                sx, Fd, F, fsr, fsc, c.r, ma, ka - k0, c.d * ma - k0);
        } else {
            load_slice<T, Core::BK, Core::BM, Core::LDX, Core::NT, false>(
                sx, Fd, F, fsr, fsc, c.r, ma, ka - k0, c.d * ma - k0);
        }
        load_slice<T, Core::BK, Core::BN, Core::LDY, Core::NT, false>(
            sy, T_ + (int64_t)c.d * ma * ldt + offb + l0, T_, ldt, 1, c.r, ma,
            kb - l0, kNoTri);
    }
    __device__ void fix(const Cursor& c, T* sx) const {
        if (fsr == 1) {
            scale_slice<T, Core::BK, Core::BM, Core::LDX, Core::NT, true>(
                sx, inv_eps[c.d]);
        } else {
            scale_slice<T, Core::BK, Core::BM, Core::LDX, Core::NT, false>(
                sx, inv_eps[c.d]);
        }
    }
    __device__ bool flush_after(const Cursor& c) const {
        const int end = c.r + Core::BK;
        return RUNS && (end - c.imin) % kRunTerms == 0 &&
               end - kRunSlice < ma;
    }
};

struct Groups {
    static constexpr int kMax = 8;
    int n;
    int off[kMax], k[kMax], m[kMax];
};

// The backward's slices: groups g ascending, rows [off_g, off_g +
// min(k_g, (d + 1) m_g)) of T_{a.,d} (past them T_{ag,d} is zero) in
// slices of BK; X(r, p) = T_a[d][p0 + p][r], Y(r, q) = S[r][offa + q0 +
// q]. With RUNS, running totals as in CapPlan, counted from off_g.
template <class Core, bool RUNS>
struct BwdPlan {
    using T = typename Core::T;
    const T *Tx, *T_, *Sy, *S;
    int64_t ldt, lds;
    Groups gr;
    int d, pn, qn;
    struct Cursor { int g, r, off, end; };

    __device__ void start(Cursor& c) const {
        c.off = gr.off[c.g];
        c.end = c.off + min(gr.k[c.g], (d + 1) * gr.m[c.g]);
        c.r = c.off;
    }
    __device__ bool begin(Cursor& c) const {
        c.g = 0;
        if (gr.n == 0) return false;
        start(c);
        return true;
    }
    __device__ bool next(Cursor& c) const {
        c.r += Core::BK;
        if (c.r >= c.end) {
            if (++c.g >= gr.n) return false;
            start(c);
        }
        return true;
    }
    __device__ void issue(const Cursor& c, T* sx, T* sy) const {
        load_slice<T, Core::BK, Core::BM, Core::LDX, Core::NT, true>(
            sx, Tx, T_, 1, ldt, c.r, c.end, pn, kNoTri);
        load_slice<T, Core::BK, Core::BN, Core::LDY, Core::NT, false>(
            sy, Sy, S, lds, 1, c.r, c.end, qn, kNoTri);
    }
    __device__ void fix(const Cursor&, T*) const {}
    __device__ bool flush_after(const Cursor& c) const {
        const int end = c.r + Core::BK;
        return RUNS && (end - c.off) % kRunTerms == 0 &&
               end - kRunSlice < c.end;
    }
};

// Stage 1: Tout[(d ma + p) ldt + qoff + q] = sum_r G[d][p][r] F_b[d mb +
// r][q] for p < ma, q < kb; grid (ceil(kb/64), ceil(ma/64), D).
template <class Core>
__global__ void __launch_bounds__(Core::NT)
gram_apply_kernel(const typename Core::T* __restrict__ G, int ma, int mb,
                  const typename Core::T* __restrict__ F, int64_t fsr,
                  int64_t fsc, int kb, const int* __restrict__ ptr,
                  const int* __restrict__ rblk,
                  typename Core::T* __restrict__ Tout, int64_t ldt,
                  int qoff) {
    using T = typename Core::T;
    constexpr int BM = Core::BM, BN = Core::BN;
    extern __shared__ __align__(16) unsigned char k2_smem[];
    T* smem = reinterpret_cast<T*>(k2_smem);
    const int q0 = blockIdx.x * BN, p0 = blockIdx.y * BM, d = blockIdx.z;
    Core core;
    // F_{b,d}[r][q] is nonzero only for q <= d mb + r
    if (q0 < (d + 1) * mb) {
        GramPlan<Core> plan;
        plan.G = G;
        plan.Gx = G + ((int64_t)d * ma + p0) * mb;
        plan.F = F;
        plan.Fy = F + (int64_t)d * mb * fsr + (int64_t)q0 * fsc;
        plan.fsr = fsr;
        plan.fsc = fsc;
        plan.rblk = rblk;
        plan.lo = ptr[d * gridDim.y + blockIdx.y];
        plan.hi = ptr[d * gridDim.y + blockIdx.y + 1];
        plan.mb = mb;
        plan.rmin = max(0, q0 - d * mb);
        plan.pn = ma - p0;
        plan.qn = kb - q0;
        plan.tri = d * mb - q0;
        run_tile(core, smem, plan);
    } else {
        core.zero();
        core.finish();
    }
    core.store(smem, BN + 1);
    __syncthreads();
    for (int e = threadIdx.x; e < BM * BN; e += Core::NT) {
        const int p = e / BN, q = e % BN;
        if (p0 + p < ma && q0 + q < kb) {
            Tout[((int64_t)d * ma + p0 + p) * ldt + qoff + q0 + q] =
                smem[p * (BN + 1) + q];
        }
    }
}

// The next tile of a persistent CTA's work list, from the launch's
// ticket: -1 past the end.
__device__ __forceinline__ int take_tile(int* ticket, int ntiles) {
    __shared__ int s_tile;
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_tile;
    return t < ntiles ? t : -1;
}

// Stage 2: block (a, b) of C, rows offa + k (k < ka), columns offb + l
// (l < kb): sum_d inv_eps[d] sum_i F_a[d ma + i][k] Ta[d][i][offb + l],
// plus 1 on the diagonal, written with its mirror. ``diag``: a == b,
// lower tiles only and, on a diagonal tile, k >= l only. Tile t of the
// work list is (work[2t], work[2t + 1]) = (tk, tl).
template <class Core, bool RUNS>
__global__ void __launch_bounds__(Core::NT)
cap_kernel(const typename Core::T* __restrict__ Fa, int64_t fsr,
           int64_t fsc, int ka, int ma, int D,
           const typename Core::T* __restrict__ Ta, int64_t ldt, int offb,
           int kb, const typename Core::T* __restrict__ inv_eps,
           typename Core::T* __restrict__ C, int64_t ldc, int offa, int diag,
           const int* __restrict__ work, int ntiles, int* ticket) {
    using T = typename Core::T;
    constexpr int BM = Core::BM, BN = Core::BN, NT = Core::NT;
    static_assert(BM == BN, "square tiles: the diagonal tiles are lower");
    extern __shared__ __align__(16) unsigned char k2_smem[];
    T* smem = reinterpret_cast<T*>(k2_smem);
    Core core;
#pragma unroll 1
    for (;;) {
        const int t = take_tile(ticket, ntiles);
        if (t < 0) break;
        const int tk = work[2 * t], tl = work[2 * t + 1];
        const int k0 = tk * BM, l0 = tl * BN;
        CapPlan<Core, RUNS> plan;
        plan.F = Fa;
        plan.T_ = Ta;
        plan.fsr = fsr;
        plan.fsc = fsc;
        plan.ldt = ldt;
        plan.inv_eps = inv_eps;
        plan.ma = ma;
        plan.D = D;
        plan.ka = ka;
        plan.kb = kb;
        plan.k0 = k0;
        plan.l0 = l0;
        plan.offb = offb;
        // float32's rows start where a 128-row tile's would
        plan.anchor = RUNS ? k0 / kAnchor * kAnchor : k0;
        run_tile(core, smem, plan);
        core.store(smem, BN + 1);
        __syncthreads();
        const bool on_diag = diag && tk == tl;
        // the tile, row by row, then its mirror, column by column
        for (int e = threadIdx.x; e < 2 * BM * BN; e += NT) {
            const bool mirror = e >= BM * BN;
            const int f = mirror ? e - BM * BN : e;
            const int r = mirror ? f % BM : f / BN;
            const int c = mirror ? f / BM : f % BN;
            if (k0 + r >= ka || l0 + c >= kb || (on_diag && c > r)) continue;
            const int64_t K = offa + k0 + r, L = offb + l0 + c;
            T v = smem[r * (BN + 1) + c];
            if (K == L) v += T(1);
            if (mirror) {
                C[L * ldc + K] = v;
            } else {
                C[K * ldc + L] = v;
            }
        }
        __syncthreads();
    }
}

// The backward of group a on 64 x 64 tiles of each F_{a,d}: Y[d ma +
// p][c] = sum_r Ta[d][p][r] S[r][offa + c], written into Fbar's buffer
// (cap_bwd_finish turns it into Fbar). Tile t of the work list:
// work[3t .. 3t + 2] = (d, pb, qb), the tiles that reach F's lower
// triangle.
template <class Core, bool RUNS>
__global__ void __launch_bounds__(Core::NT)
cap_bwd_kernel(int ka, int ma, const typename Core::T* __restrict__ Ta,
               int64_t ldt, const typename Core::T* __restrict__ S,
               int64_t lds, int offa, Groups gr,
               typename Core::T* __restrict__ Y,
               const int* __restrict__ work, int ntiles, int* ticket) {
    using T = typename Core::T;
    constexpr int BM = Core::BM, BN = Core::BN, NT = Core::NT;
    extern __shared__ __align__(16) unsigned char k2_smem[];
    T* smem = reinterpret_cast<T*>(k2_smem);
    Core core;
#pragma unroll 1
    for (;;) {
        const int t = take_tile(ticket, ntiles);
        if (t < 0) break;
        const int d = work[3 * t], p0 = work[3 * t + 1] * BM;
        const int q0 = work[3 * t + 2] * BN;
        const int64_t dma = (int64_t)d * ma;
        BwdPlan<Core, RUNS> plan;
        plan.Tx = Ta + (dma + p0) * ldt;
        plan.T_ = Ta;
        plan.Sy = S + offa + q0;
        plan.S = S;
        plan.ldt = ldt;
        plan.lds = lds;
        plan.gr = gr;
        plan.d = d;
        plan.pn = ma - p0;
        plan.qn = ka - q0;
        run_tile(core, smem, plan);
        core.store(smem, BN + 1);
        __syncthreads();
        for (int e = threadIdx.x; e < BM * BN; e += NT) {
            const int r = e / BN, c = e % BN;
            if (p0 + r < ma && q0 + c < ka) {
                Y[(dma + p0 + r) * ka + q0 + c] = smem[r * (BN + 1) + c];
            }
        }
        __syncthreads();
    }
}

// Fbar from Y in place, on the 128 x 128 tiles of each F_{a,d}: Fbar =
// inv_eps[d] Y on F_a's lower triangle (c <= d ma + p), 0 above, and
// each tile's sum of F_a * Y into partial[d * pstride + pb * ntx + qb]
// (0 where the tile lies wholly above the diagonal: the caller zeroes
// ``partial``). Grid (ntx, ceil(ma / 128), D), 256 threads; the tile
// goes through shared memory 32 rows at a time.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
cap_bwd_finish_kernel(const T* __restrict__ Fa, int64_t fsr, int64_t fsc,
                      int ka, int ma, const T* __restrict__ inv_eps,
                      T* __restrict__ Fbar, T* __restrict__ partial,
                      int64_t pstride) {
    constexpr int BT = kBwdTile, H = 32, NT = kBwdThreads;
    constexpr int S16 = 16;  // the partials' thread grid, 16 x 16
    __shared__ T ys[H][BT + 1];
    __shared__ T red[NT];
    const int qb = blockIdx.x, pb = blockIdx.y, d = blockIdx.z;
    const int p0 = pb * BT, q0 = qb * BT;
    const int64_t dma = (int64_t)d * ma;
    const int plast = min(p0 + BT, ma) - 1;
    if (q0 > dma + plast) {  // wholly above F's diagonal
        for (int e = threadIdx.x; e < BT * BT; e += NT) {
            const int p = p0 + e / BT, c = q0 + e % BT;
            if (p < ma && c < ka) Fbar[(dma + p) * ka + c] = T(0);
        }
        return;
    }
    const T s = inv_eps[d];
    // thread (tx, ty) of a 16 x 16 grid sums F * Y over rows ty + 16 i
    // and columns tx + 16 j, i then j; the physical thread that does it
    // walks F along its storage order
    const int lt = threadIdx.x;
    const int tx = fsr == 1 ? lt / S16 : lt % S16;
    const int ty = fsr == 1 ? lt % S16 : lt / S16;
    T part = T(0);
    for (int h = 0; h < BT / H; ++h) {
        const int r0 = p0 + h * H;
        for (int e = threadIdx.x; e < H * BT; e += NT) {
            const int r = e / BT, c = e % BT;
            if (r0 + r < ma && q0 + c < ka) {
                ys[r][c] = Fbar[(dma + r0 + r) * ka + q0 + c];
            }
        }
        __syncthreads();
#pragma unroll
        for (int i = h * H / S16; i < (h + 1) * H / S16; ++i) {
            const int p = p0 + ty + i * S16;
            if (p >= ma) continue;
            const int64_t row = dma + p;
#pragma unroll
            for (int j = 0; j < BT / S16; ++j) {
                const int c = q0 + tx + j * S16;
                if (c >= ka) continue;
                const T y = c <= row ? ys[ty + i * S16 - h * H][tx + j * S16]
                                     : T(0);
                part = madd(Fa[row * fsr + c * fsc], y, part);
            }
        }
        for (int e = threadIdx.x; e < H * BT; e += NT) {
            const int r = e / BT, c = e % BT;
            const int64_t row = dma + r0 + r;
            if (r0 + r < ma && q0 + c < ka) {
                Fbar[row * ka + q0 + c] = s * (q0 + c <= row ? ys[r][c] : T(0));
            }
        }
        __syncthreads();
    }
    red[ty * S16 + tx] = part;
    __syncthreads();
    for (int w = NT / 2; w > 0; w >>= 1) {
        if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        partial[d * pstride + (int64_t)pb * gridDim.x + qb] = red[0];
    }
}

// S = Cbar + Cbar^T, (k, k) row-major: a 32 x 32 tile per CTA, the
// transposed tile through shared memory, both reads coalesced.
template <typename T>
__global__ void __launch_bounds__(256)
cap_sym_kernel(const T* __restrict__ Cbar, int k, T* __restrict__ S) {
    __shared__ T tile[32][33];
    const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    for (int i = ty; i < 32; i += 8) {  // tile[i][j] = Cbar[c0 + i][r0 + j]
        if (c0 + i < k && r0 + tx < k) {
            tile[i][tx] = Cbar[(int64_t)(c0 + i) * k + r0 + tx];
        }
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
        const int r = r0 + i, c = c0 + tx;
        if (r < k && c < k) {
            S[(int64_t)r * k + c] = Cbar[(int64_t)r * k + c] + tile[tx][i];
        }
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

// The tile configurations: 64 x 64 output tiles. Float32: 8 x 4 a
// thread, 128 threads, 16-deep slices in stage 1 (the plan's) and 32
// past it. Float64: four warps of 32 x 32, 16-deep slices. 64 x 64
// stage-2 tiles (four CTAs an SM) ran faster than 128 x 128 (one) at
// every site on an H100, the weather twin's k = 10016 included; in the
// backward, 128 x 128 tiles made about 2.7 waves of uneven depth at
// fx2007.
template <typename T> struct Cfg;
template <> struct Cfg<float> {
    using Gram = FmaCore<64, 64, 8, 4, kPlanCols>;
    using Cap = FmaCore<64, 64, 8, 4, 32>;
    static constexpr bool kRuns = true;
};
template <> struct Cfg<double> {
    using Gram = MmaCore<64, 64, 2, 2, kPlanCols>;
    using Cap = MmaCore<64, 64, 2, 2, 16>;
    static constexpr bool kRuns = false;
};

std::mutex& launch_lock() {
    static std::mutex lock;
    return lock;
}

// The shared-memory opt-in of ``kern`` and, with ``persistent``, the
// CTAs co-resident on the device (``capacity``): once per device and
// kernel (``facts`` is the kernel's own table).
template <typename K>
int prepare(K kern, int threads, size_t smem, int* facts, int* capacity) {
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
                                                            threads, smem);
        if (err != cudaSuccess) return (int)err;
        facts[dev] = (per_sm > 0 ? per_sm : 1) * nsm;
    }
    *capacity = facts[dev];
    return 0;
}

template <typename T>
int gram_apply(const T* G, int D, int ma, int mb, const T* F, int64_t fsr,
               int64_t fsc, int kb, const int* ptr, const int* rblk,
               T* Tout, int64_t ldt, int qoff, int plan_rows, int plan_cols,
               void* stream) {
    using Core = typename Cfg<T>::Gram;
    if (plan_rows != kPlanRows || plan_cols != kPlanCols) return -1;
    constexpr size_t smem = smem_bytes<Core>();
    static int facts[kMaxDevices] = {};
    int capacity = 0;
    const int rc = prepare(gram_apply_kernel<Core>, Core::NT, smem, facts,
                           &capacity);
    if (rc != 0) return rc;
    dim3 grid((unsigned)((kb + Core::BN - 1) / Core::BN),
              (unsigned)((ma + Core::BM - 1) / Core::BM), (unsigned)D);
    gram_apply_kernel<Core><<<grid, Core::NT, smem, (cudaStream_t)stream>>>(
        G, ma, mb, F, fsr, fsc, kb, ptr, rblk, Tout, ldt, qoff);
    return (int)cudaGetLastError();
}

template <typename T>
int cap(const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,
        const T* Ta, int64_t ldt, int offb, int kb, const T* inv_eps, T* C,
        int64_t ldc, int offa, int diag, const int* work, int ntiles,
        int* ticket, void* stream) {
    using Core = typename Cfg<T>::Cap;
    constexpr bool R = Cfg<T>::kRuns;
    constexpr size_t smem = smem_bytes<Core>();
    static int facts[kMaxDevices] = {};
    int capacity = 0;
    const int rc = prepare(cap_kernel<Core, R>, Core::NT, smem, facts,
                           &capacity);
    if (rc != 0) return rc;
    if (ntiles <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const int grid = ntiles < capacity ? ntiles : capacity;
    cap_kernel<Core, R><<<grid, Core::NT, smem, s>>>(
        Fa, fsr, fsc, ka, ma, D, Ta, ldt, offb, kb, inv_eps, C, ldc, offa,
        diag, work, ntiles, ticket);
    return (int)cudaGetLastError();
}

template <typename T>
int cap_bwd(const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,
            const T* Ta, int64_t ldt, const T* S, int64_t lds, int offa,
            int ngroups, const int* goff, const int* gk, const int* gm,
            const T* inv_eps, T* Fbar, T* partial, int64_t pstride,
            const int* work, int ntiles, int* ticket, void* stream) {
    using Core = typename Cfg<T>::Cap;
    constexpr bool R = Cfg<T>::kRuns;
    if (ngroups > Groups::kMax || ngroups < 0) return -1;
    Groups gr;
    gr.n = ngroups;
    for (int g = 0; g < ngroups; ++g) {
        gr.off[g] = goff[g];
        gr.k[g] = gk[g];
        gr.m[g] = gm[g];
    }
    constexpr size_t smem = smem_bytes<Core>();
    static int facts[kMaxDevices] = {};
    int capacity = 0;
    const int rc = prepare(cap_bwd_kernel<Core, R>, Core::NT, smem, facts,
                           &capacity);
    if (rc != 0) return rc;
    const cudaStream_t s = (cudaStream_t)stream;
    if (ntiles > 0) {
        cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(int), s);
        if (err != cudaSuccess) return (int)err;
        const int grid = ntiles < capacity ? ntiles : capacity;
        cap_bwd_kernel<Core, R><<<grid, Core::NT, smem, s>>>(
            ka, ma, Ta, ldt, S, lds, offa, gr, Fbar, work, ntiles, ticket);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    dim3 fgrid((unsigned)((ka + kBwdTile - 1) / kBwdTile),
               (unsigned)((ma + kBwdTile - 1) / kBwdTile), (unsigned)D);
    cap_bwd_finish_kernel<T><<<fgrid, kBwdThreads, 0, s>>>(
        Fa, fsr, fsc, ka, ma, inv_eps, Fbar, partial, pstride);
    return (int)cudaGetLastError();
}

template <typename T>
int sym(const T* Cbar, int k, T* S, void* stream) {
    if (k <= 0) return 0;
    dim3 grid((unsigned)((k + 31) / 32), (unsigned)((k + 31) / 32));
    cap_sym_kernel<T><<<grid, 256, 0, (cudaStream_t)stream>>>(Cbar, k, S);
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

#define K2_ENTRIES(T, SFX)                                                    \
    extern "C" int k2_gram_apply_##SFX(                                      \
        const T* G, int D, int ma, int mb, const T* F, int64_t fsr,           \
        int64_t fsc, int kb, const int* ptr, const int* rblk, T* Tout,        \
        int64_t ldt, int qoff, int plan_rows, int plan_cols, void* stream) {  \
        return gram_apply<T>(G, D, ma, mb, F, fsr, fsc, kb, ptr, rblk, Tout,  \
                             ldt, qoff, plan_rows, plan_cols, stream);        \
    }                                                                         \
    extern "C" int k2_cap_##SFX(                                             \
        const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,         \
        const T* Ta, int64_t ldt, int offb, int kb, const T* inv_eps, T* C,   \
        int64_t ldc, int offa, int diag, const int* work, int ntiles,         \
        int* ticket, void* stream) {                                          \
        return cap<T>(Fa, fsr, fsc, ka, ma, D, Ta, ldt, offb, kb, inv_eps, C, \
                      ldc, offa, diag, work, ntiles, ticket, stream);         \
    }                                                                         \
    extern "C" int k2_cap_bwd_##SFX(                                         \
        const T* Fa, int64_t fsr, int64_t fsc, int ka, int ma, int D,         \
        const T* Ta, int64_t ldt, const T* S, int64_t lds, int offa,          \
        int ngroups, const int* goff, const int* gk, const int* gm,           \
        const T* inv_eps, T* Fbar, T* partial, int64_t pstride,               \
        const int* work, int ntiles, int* ticket, void* stream) {             \
        return cap_bwd<T>(Fa, fsr, fsc, ka, ma, D, Ta, ldt, S, lds, offa,     \
                          ngroups, goff, gk, gm, inv_eps, Fbar, partial,      \
                          pstride, work, ntiles, ticket, stream);             \
    }                                                                         \
    extern "C" int k2_sym_##SFX(const T* Cbar, int k, T* S, void* stream) {   \
        return sym<T>(Cbar, k, S, stream);                                    \
    }                                                                         \
    extern "C" int k2_eps_reduce_##SFX(const T* partial, int ngroups, int D,  \
                                       int ntiles, T* out, void* stream) {    \
        return eps_reduce<T>(partial, ngroups, D, ntiles, out, stream);       \
    }

K2_ENTRIES(float, f32)
K2_ENTRIES(double, f64)
