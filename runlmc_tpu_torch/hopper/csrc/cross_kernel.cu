// K7 (+K8): the dense LMC cross-covariance
//
//   K[a,b] = sum_q B[q, oa[a], ob[b]] * scale_q * k~_q(r_q(a,b)),
//   r_q(a,b) = || xa[a] - xb[b] || over the input dims in mask_q,
//
// with k~_q one of RBF, Matern32, StdPeriodic or Identity by a per-q kind
// code, and (gamma, period, scale) read from a small per-q table
// (Scaled kernels fold their sigma into scale).
//
// Replaces the XLA code at runlmc_tpu/lmc/likelihood.py:76-96
// (pairwise_dists + cross_kernel) and the elementwise k(r) of
// runlmc_tpu/kernels/stationary.py:64-157, which XLA runs as a
// distance tensor per active-dim group, a k(r) tensor per q, and a
// gathered (na, nb) coregionalization scale per q. Here nothing but K
// itself is written.
//
// Bound on the card: the (na, nb) output write (77.5 MB in f64 at the
// fx2007 exact kernel (3113, 3113): 23 us at 3.35 TB/s; 1.99 GB at the
// weather oracle (15768, 15768): 594 us), or the exp / sin evaluations,
// Q per unordered pair where both point sets are one.
//
// Every element sums, in q order, fma(B[q, oa[a], ob[b]] * scale_q,
// k~_q, acc) from acc = 0, with k~_q from the squared distance d2: RBF
// as exp(-0.5 d2 gamma), Identity as d2 == 0, and r = sqrt(d2) only for
// Matern32 and StdPeriodic. d2 is the same for (a, b) and (b, a), so both
// paths below give the same bits for the same inputs.
//
// - Pair path (xa, oa are xb, ob, sorted by output: every square call
//   of the model's paths). The points are cut into tiles of at most
//   kTile that never straddle two outputs (hopper/cross.py bwd_plan, the
//   plan K7's backward runs on). Persistent CTAs (as many as are
//   resident at once) walk the tile pairs (I, J), I >= J; for each,
//   B[q, out I, out J] * scale_q and B[q, out J, out I] * scale_q are
//   constants in shared memory beside the table, and each unordered
//   pair's k~_q is evaluated once for K[a, b] (stored directly,
//   consecutive threads on consecutive columns) and K[b, a] (through a
//   padded shared-memory transpose, so that it is stored coalesced too).
//   On a diagonal tile the pairs a > b take both, a = b only K[a, a]:
//   every element is written once. The next pair's points and B entries
//   are copied (cp.async) into a second buffer while a pair is
//   evaluated.
//   Distances: once per element and distinct active-dim mask among a
//   pass's kernels (the kernels that share a mask take its distance in
//   turn), the sqrt only where a Matern32 or StdPeriodic kernel of that
//   mask needs r. A table of RBF kernels on one mask (the weather
//   oracle's) runs a path without a branch between the kernels, so
//   their exps overlap. More than kMaxQ kernels run as further passes
//   over slices of q inside the same element, the sum carried on.
//   The distance, the pass's facts (whose distance a kernel takes, which
//   mask needs r, the one-mask RBF table) and k~ from d2 are
//   k7_common.cuh's, which K7's backward runs too.
// - General path (distinct point sets, or outputs not sorted): a thread
//   per column and kRows rows, everything read from global memory, a
//   row group's loads all ahead of its stores; a distance once for each
//   run of kernels on one mask, the sqrt only where a kernel needs r.

#include "k7_common.cuh"

namespace {

constexpr int kTile = 64;             // points per tile (hopper/cross.py TILE)
constexpr int kLd = kTile + 1;        // padded row of the transposed tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 16
constexpr int kMaxQ = 8;              // kernels per pass
constexpr int kRows = 4;              // rows a thread, general path

// The kernel table in shared memory: per q its kind, mask, the first
// kernel of its pass on the same mask (whose distance it takes), whether
// that mask needs r, gamma, period and scale; one_rbf: every kernel RBF
// on one mask.
template <typename T>
struct Table {
    int* kind;
    int* mask;
    int* first;
    int* needr;
    T* gam;
    T* per;
    T* scale;
    int* one_rbf;

    static size_t bytes(int Q) {
        return sizeof(T) * 3 * (size_t)Q + sizeof(int) * (4 * (size_t)Q + 1);
    }
    // carved from p (T-aligned); returns the end
    __device__ unsigned char* carve(unsigned char* p, int Q) {
        gam = reinterpret_cast<T*>(p);
        per = gam + Q;
        scale = per + Q;
        kind = reinterpret_cast<int*>(scale + Q);
        mask = kind + Q;
        first = mask + Q;
        needr = first + Q;
        one_rbf = needr + Q;
        return reinterpret_cast<unsigned char*>(one_rbf + 1);
    }
    // the whole CTA (a barrier must follow): the table and its derived
    // columns, all read from global memory at once; passes of nq kernels
    __device__ void load(const int* __restrict__ kinds,
                         const int* __restrict__ masks,
                         const T* __restrict__ prm, int Q, int nq) {
        for (int q = threadIdx.x; q < Q; q += blockDim.x) {
            kind[q] = kinds[q];
            mask[q] = masks[q];
            gam[q] = prm[3 * q];
            per[q] = prm[3 * q + 1];
            scale[q] = prm[3 * q + 2];
            const int q0 = q - q % nq;
            runlmc::pass_facts(kinds, masks, q, q0, min(Q, q0 + nq),
                               first[q], needr[q]);
        }
        if (threadIdx.x == blockDim.x - 1) {
            *one_rbf = runlmc::one_mask_rbf(kinds, masks, 0, Q);
        }
    }
};

// k~_q of the element of points pa, pb (P dims, in shared memory) for
// the pass q0 .. q0 + nq - 1 (nq <= NQ) into kt
template <typename T, int NQ>
__device__ __forceinline__ void pass_values(const Table<T>& tb, int q0,
                                            int nq, bool one_rbf,
                                            const T* pa, const T* pb, int P,
                                            T (&kt)[NQ]) {
    if (one_rbf) {  // no branch between the kernels: their exps overlap
        const T d2 = runlmc::sq_dist<T>(tb.mask[0], pa, pb, P);
#pragma unroll
        for (int f = 0; f < NQ; ++f) {
            kt[f] = f < nq ? runlmc::dexp(T(-0.5) * d2 * tb.gam[q0 + f])
                           : T(0);
        }
        return;
    }
    // each distinct mask's distance once, for the kernels that share it
#pragma unroll
    for (int f = 0; f < NQ; ++f) {
        const int q = q0 + f;
        if (f >= nq || tb.first[q] != q) continue;
        const T d2 = runlmc::sq_dist<T>(tb.mask[q], pa, pb, P);
        const T r = tb.needr[q] ? runlmc::dsqrt(d2) : T(0);
#pragma unroll
        for (int g = f; g < NQ; ++g) {
            const int qg = q0 + g;
            if (g < nq && tb.first[qg] == q) {
                kt[g] = runlmc::kern_d2<T>(tb.kind[qg], d2, r, tb.gam[qg],
                                           tb.per[qg]);
            }
        }
    }
}

// A tile pair's place: rows (r0, rl) of output dI, columns (c0, cl) of
// output dJ
struct PairMeta {
    int r0, rl, dI, c0, cl, dJ;
};

__device__ __forceinline__ PairMeta pair_meta(const int* __restrict__ tiles,
                                              const int* __restrict__ pairs,
                                              int p) {
    const int I = pairs[2 * p], J = pairs[2 * p + 1];
    return {tiles[3 * I], tiles[3 * I + 1], tiles[3 * I + 2],
            tiles[3 * J], tiles[3 * J + 1], tiles[3 * J + 2]};
}

// A pair's operands into buffer (xr, xc, braw): the two tiles' points
// and B[q, dI, dJ], B[q, dJ, dI] for every q
template <typename T>
__device__ __forceinline__ void stage_pair(const PairMeta& pm,
                                           const T* __restrict__ x,
                                           const T* __restrict__ B, int P,
                                           int Q, int D, T* xr, T* xc,
                                           T* braw) {
    for (int idx = threadIdx.x; idx < kTile * P; idx += kThreads) {
        const int r = idx / P;
        runlmc::cp_async_elem(
            xr + idx, r < pm.rl ? x + (int64_t)pm.r0 * P + idx : x,
            r < pm.rl);
        runlmc::cp_async_elem(
            xc + idx, r < pm.cl ? x + (int64_t)pm.c0 * P + idx : x,
            r < pm.cl);
    }
    for (int q = threadIdx.x; q < Q; q += kThreads) {
        runlmc::cp_async_elem(
            braw + q, B + ((int64_t)q * D + pm.dI) * D + pm.dJ, true);
        runlmc::cp_async_elem(
            braw + Q + q, B + ((int64_t)q * D + pm.dJ) * D + pm.dI, true);
    }
    runlmc::cp_async_commit();
}

template <typename T>
size_t pair_smem(int P, int Q) {
    return sizeof(T) * ((size_t)kTile * kLd + 4 * (size_t)kTile * P +
                        6 * (size_t)Q) +
           Table<T>::bytes(Q);
}

// Persistent CTAs over the tile pairs p = (I, J), I >= J, of the sorted
// point set x (n, P), p = blockIdx.x, blockIdx.x + gridDim.x, ...: K[I, J]
// and K[J, I]. The next pair's points and B entries are copied into the
// other of two buffers (cp.async) while this pair is evaluated. tiles
// (ntiles, 3) rows (start, length, output), pairs (npairs, 2).
template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads, 3)
k7_pair_kernel(const T* __restrict__ x, const T* __restrict__ B,
               const int* __restrict__ kinds, const int* __restrict__ masks,
               const T* __restrict__ prm, const int* __restrict__ tiles,
               const int* __restrict__ pairs, int npairs,
               T* __restrict__ out, int n, int P, int Q, int D) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Ts = reinterpret_cast<T*>(smem_raw);  // K[J, I] staged, [c][r]
    T* xbuf = Ts + kTile * kLd;              // two (xr, xc) buffers
    T* braw = xbuf + 4 * kTile * P;          // two (Q, 2) B buffers
    T* bs1 = braw + 4 * Q;  // B[q, out I, out J] * scale_q
    T* bs2 = bs1 + Q;       // B[q, out J, out I] * scale_q
    Table<T> tb;
    tb.carve(reinterpret_cast<unsigned char*>(bs2 + Q), Q);
    tb.load(kinds, masks, prm, Q, NQ);

    const int tid = threadIdx.x;
    int p = blockIdx.x;
    PairMeta pm = pair_meta(tiles, pairs, p);
    stage_pair<T>(pm, x, B, P, Q, D, xbuf, xbuf + kTile * P, braw);
    const int c = tid % kTile;
    const int rb = tid / kTile;
    for (int it = 0; p < npairs; ++it, p += gridDim.x) {
        const int buf = it & 1;
        T* xr = xbuf + buf * 2 * kTile * P;
        T* xc = xr + kTile * P;
        const T* bq = braw + buf * 2 * Q;
        const int pn = p + gridDim.x;
        // the next pair's place, read while this pair's copies land
        const PairMeta next = pn < npairs ? pair_meta(tiles, pairs, pn) : pm;
        runlmc::cp_async_wait_all();
        __syncthreads();  // this pair's operands are in; Ts is free
        for (int q = tid; q < Q; q += kThreads) {
            bs1[q] = bq[q] * tb.scale[q];
            bs2[q] = bq[Q + q] * tb.scale[q];
        }
        __syncthreads();
        if (pn < npairs) {  // the next pair into the other buffer
            T* nx = xbuf + (buf ^ 1) * 2 * kTile * P;
            stage_pair<T>(next, x, B, P, Q, D, nx, nx + kTile * P,
                          braw + (buf ^ 1) * 2 * Q);
        }
        const bool diag = pm.r0 == pm.c0;
        const bool one_rbf = *tb.one_rbf != 0;
#pragma unroll 2
        for (int i = 0; i < kRowsPerThread; ++i) {
            const int r = rb + (kThreads / kTile) * i;
            if (r >= pm.rl || c >= pm.cl || (diag && r < c)) continue;
            T acc1 = 0, acc2 = 0;
            for (int q0 = 0; q0 < Q; q0 += NQ) {
                const int nq = min(NQ, Q - q0);
                T kt[NQ];
                pass_values<T, NQ>(tb, q0, nq, one_rbf, xr + r * P,
                                   xc + c * P, P, kt);
#pragma unroll
                for (int f = 0; f < NQ; ++f) {
                    if (f < nq) {
                        acc1 = runlmc::dfma(bs1[q0 + f], kt[f], acc1);
                        acc2 = runlmc::dfma(bs2[q0 + f], kt[f], acc2);
                    }
                }
            }
            out[(int64_t)(pm.r0 + r) * n + pm.c0 + c] = acc1;
            Ts[c * kLd + r] = acc2;
        }
        __syncthreads();
        // K[J, I]: row c0 + cc, columns r0 + rr, consecutive threads on rr
        const int rr = tid % kTile;
        for (int cc = tid / kTile; cc < pm.cl; cc += kThreads / kTile) {
            if (rr < pm.rl && (!diag || rr > cc)) {
                out[(int64_t)(pm.c0 + cc) * n + pm.r0 + rr] =
                    Ts[cc * kLd + rr];
            }
        }
        pm = next;
    }
}

// A thread per column b and kRows rows a CTA (rows past gridDim.y go
// round a grid-stride loop): every operand read from global memory (the
// table and B through the cache), all of a row group's loads ahead of
// its stores; each distinct mask's distance once for the kernels that
// follow it, the sqrt only where a kernel needs r.
template <typename T>
__global__ void __launch_bounds__(kThreads)
k7_general_kernel(const T* __restrict__ xa, const int* __restrict__ oa,
                  const T* __restrict__ xb, const int* __restrict__ ob,
                  const T* __restrict__ B, const int* __restrict__ kinds,
                  const int* __restrict__ masks, const T* __restrict__ prm,
                  T* __restrict__ out, int na, int nb, int P, int Q, int D) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b >= nb) return;
    const int db = ob[b];
    const T* pb = xb + (int64_t)b * P;
    for (int64_t a0 = (int64_t)blockIdx.y * kRows; a0 < na;
         a0 += (int64_t)gridDim.y * kRows) {
        int da[kRows];
        const T* pa[kRows];
        T acc[kRows], d2[kRows], r[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int64_t a = a0 + i < na ? a0 + i : na - 1;
            da[i] = oa[a];
            pa[i] = xa + a * P;
            acc[i] = T(0);
        }
        int mask = -1;
        bool have_r = false;
        for (int q = 0; q < Q; ++q) {
            const int kind = kinds[q], mk = masks[q];
            const T gamma = prm[3 * q], period = prm[3 * q + 1];
            const T scale = prm[3 * q + 2];
            if (mk != mask) {
#pragma unroll
                for (int i = 0; i < kRows; ++i) {
                    d2[i] = runlmc::sq_dist<T>(mk, pa[i], pb, P);
                }
                mask = mk;
                have_r = false;
            }
            if (!have_r && (kind == runlmc::kMatern32 ||
                            kind == runlmc::kStdPeriodic)) {
#pragma unroll
                for (int i = 0; i < kRows; ++i) r[i] = runlmc::dsqrt(d2[i]);
                have_r = true;
            }
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const T kt =
                    runlmc::kern_d2<T>(kind, d2[i], r[i], gamma, period);
                const T bs = B[((int64_t)q * D + da[i]) * D + db] * scale;
                acc[i] = runlmc::dfma(bs, kt, acc[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            if (a0 + i < na) out[(a0 + i) * nb + b] = acc[i];
        }
    }
}

template <typename T, int NQ>
int launch_nq(const T* xa, const int* oa, const T* xb, const int* ob,
              const T* B, const int* kinds, const int* masks, const T* prm,
              const int* plan, int nta, int ntb, int npairs, T* out, int na,
              int nb, int P, int Q, int D, cudaStream_t s) {
    int per_sm = 0, sms = 0;
    if (plan != nullptr) {
        auto kern = k7_pair_kernel<T, NQ>;
        const size_t smem = pair_smem<T>(P, Q);
        int optin = 0;
        const int rc = runlmc::launch_facts((const void*)kern, kThreads,
                                            smem, &optin, &sms, &per_sm);
        if (rc != 0) return rc;
        if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        const int* tiles = plan;
        const int* pairs = plan + 3 * (nta + ntb);
        const int ctas = per_sm * sms < npairs ? per_sm * sms : npairs;
        kern<<<(unsigned)ctas, kThreads, smem, s>>>(
            xa, B, kinds, masks, prm, tiles, pairs, npairs, out, na, P, Q, D);
        return (int)cudaGetLastError();
    }
    dim3 grid((unsigned)((nb + kThreads - 1) / kThreads),
              runlmc::grid_y((na + kRows - 1) / kRows));
    k7_general_kernel<T><<<grid, kThreads, 0, s>>>(
        xa, oa, xb, ob, B, kinds, masks, prm, out, na, nb, P, Q, D);
    return (int)cudaGetLastError();
}

// plan: nullptr for the general path, else int32 [ta (nta, 3) | tb |
// pairs (npairs, 2) | ...] as hopper/cross.py bwd_plan packs it (one
// point set: xa is xb, na = nb)
template <typename T>
int launch(const T* xa, const int* oa, const T* xb, const int* ob,
           const T* B, const int* kinds, const int* masks, const T* prm,
           const int* plan, int nta, int ntb, int npairs, T* out, int na,
           int nb, int P, int Q, int D, void* stream) {
    if (Q < 1 || P < 1 || P > 31 || na < 1 || nb < 1 ||
        (plan != nullptr && (npairs < 1 || na != nb))) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
#define K7_NQ(N)                                                            \
    case N:                                                                 \
        return launch_nq<T, N>(xa, oa, xb, ob, B, kinds, masks, prm, plan,  \
                               nta, ntb, npairs, out, na, nb, P, Q, D, s);
    switch (Q < kMaxQ ? Q : kMaxQ) {
        K7_NQ(1)
        K7_NQ(2)
        K7_NQ(3)
        K7_NQ(4)
        K7_NQ(5)
        K7_NQ(6)
        K7_NQ(7)
        K7_NQ(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef K7_NQ
}

}  // namespace

extern "C" int cross_kernel_f32(const float* xa, const int* oa,
                                const float* xb, const int* ob,
                                const float* B, const int* kinds,
                                const int* masks, const float* prm,
                                const int* plan, int nta, int ntb,
                                int npairs, float* out, int na, int nb,
                                int P, int Q, int D, void* stream) {
    return launch<float>(xa, oa, xb, ob, B, kinds, masks, prm, plan, nta,
                         ntb, npairs, out, na, nb, P, Q, D, stream);
}

extern "C" int cross_kernel_f64(const double* xa, const int* oa,
                                const double* xb, const int* ob,
                                const double* B, const int* kinds,
                                const int* masks, const double* prm,
                                const int* plan, int nta, int ntb,
                                int npairs, double* out, int na, int nb,
                                int P, int Q, int D, void* stream) {
    return launch<double>(xa, oa, xb, ob, B, kinds, masks, prm, plan, nta,
                          ntb, npairs, out, na, nb, P, Q, D, stream);
}
