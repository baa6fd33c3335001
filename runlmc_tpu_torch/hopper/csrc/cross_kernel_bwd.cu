// K7 backward: the parameter cotangents of the dense LMC cross-covariance
// (cross_kernel.cu) from the cotangent G = dL/dK (na, nb),
//
//   K[a,b] = sum_q B[q, oa[a], ob[b]] * scale_q * k~_q(r_q(a,b)),
//
// reduced per q into three tables over the pair of outputs (d, e),
//
//   S0[q,d,e] = sum_{oa[a] = d, ob[b] = e} G[a,b] k~_q(r)
//   S1[q,d,e] = sum_{oa[a] = d, ob[b] = e} G[a,b] dk~_q/dgamma
//   S2[q,d,e] = sum_{oa[a] = d, ob[b] = e} G[a,b] dk~_q/dperiod
//
// (k~ the unscaled kernel), and finished with dB_q = scale_q S0_q,
// dscale_q = <B_q, S0_q>, dgamma_q = scale_q <B_q, S1_q>, dperiod_q =
// scale_q <B_q, S2_q>. With a vector alpha the kernel reads
// G[a,b] - alpha_a alpha_b in place of G[a,b]: the exact oracle's gradient
// hands it K^-1 and alpha = K^-1 y (lmc/likelihood.py ExactMLL), so the
// rank-1 term of 1/2 (K^-1 - alpha alpha^T) is formed in the loads and
// never stored.
//
// Replaces XLA's autodiff of runlmc_tpu/lmc/likelihood.py:85-96 inside
// jax.grad of exact_mll, which keeps a distance tensor per active-dim
// group and a gathered (na, nb) coregionalization scale per q and runs
// their transposes. Here each element's distance and k~_q(r) are
// recomputed from the inputs: no (Q, na, nb) stack is stored or loaded.
//
// Bound on the card: reading G once, na * nb elements (77.5 MB in f64 at
// the fx2007 shape (3113, 3113): 23 us at 3.35 TB/s; 1.99 GB at the
// weather oracle (15768, 15768): 594 us), or the exp / sin / cos
// evaluations, Q per unordered pair where both point sets are one.
//
// Design. The rows and columns come sorted by output (the model's own
// layout; hopper/cross.py sorts other inputs first) and are cut into
// tiles of at most kTile points that never straddle two outputs, so a
// tile pair (I, J) feeds exactly one (d, e). The host plan
// (cross.bwd_plan) lists the tile pairs and, per (d, e), the partial
// slots that feed it.
//
// - Pair path (xa, oa are xb, ob: every call on the model's paths). Only
//   the tile pairs I >= J run. A CTA stages G[I, J] and G[J, I] with
//   cp.async into shared memory (the second read transposed from there),
//   the tiles' inputs and alpha beside them, and evaluates each element's
//   k~_q and its two derivatives once for both G[a,b] and G[b,a]: the
//   first feeds (out I, out J), the second (out J, out I). On a diagonal
//   tile the pairs a > b take both, a = b only G[a,a], a < b nothing:
//   every unordered pair once, every diagonal element once.
// - General path (distinct point sets): every tile pair, G[I, J] only.
// - Distances: once per element and distinct active-dim mask among the
//   launch's kernels (the kernels that share a mask take its distance in
//   turn), and the sqrt only where a Matern32 or StdPeriodic kernel of
//   that mask needs r: RBF and Identity read r^2 itself. A table of RBF
//   kernels on one mask (the weather oracle's) runs a path without a
//   branch between the kernels, so their exps overlap.
//   These facts, the distance and k~ from d2 are k7_common.cuh's, shared
//   with K7's forward.
// - With alpha, G[a,b] - alpha_a alpha_b rounds the product first, as
//   torch.addr and the plain version do.
// - A column-major G on the pair path (the oracle's K^-1 from
//   cholesky_inverse) is read as the row-major G^T, with G[a,b] and
//   G[b,a] swapped (gt): no transposing copy.
// - Each thread keeps 3 (6 on the pair path) accumulators per kernel;
//   a fixed butterfly of shuffles and a fixed pass over the warps reduce
//   them, and one thread per value writes the tile pair's partials.
// - The finishing pass runs a CTA per (d, e, q): its threads stride over
//   the partials the plan lists for (d, e), then a fixed butterfly and
//   a fixed pass over the warps; the last CTA (a ticket, which only
//   picks who finishes) does the four small products, a warp per q.
// Every sum runs in a fixed order: the same result on every run, no
// atomics in any sum. More than kMaxQ kernels run as further tile
// launches over slices of q (each launch writes its own q's partials).

#include "k7_common.cuh"

namespace {

constexpr int kTile = 64;             // points per tile (hopper/cross.py TILE)
constexpr int kLd = kTile + 1;        // padded row of a staged tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 16
constexpr int kMaxQ = 8;              // kernels per tile launch
constexpr int kFinThreads = 256;
constexpr int kMaxDevices = 16;

// g - a * b with the product rounded first (never contracted into an
// FMA): the rank-1 term as torch.addr and the plain version form it
__device__ __forceinline__ float sub_prod(float g, float a, float b) {
    return __fsub_rn(g, __fmul_rn(a, b));
}
__device__ __forceinline__ double sub_prod(double g, double a, double b) {
    return __dsub_rn(g, __dmul_rn(a, b));
}

template <typename T, int NQ, bool PAIR>
struct TileCfg {
    static constexpr int kVals = (PAIR ? 6 : 3) * NQ;
    // shared memory: the staged tiles, the tiles' inputs and alpha, the
    // warps' sums and the launch's slice of the table
    static size_t smem(int P) {
        return sizeof(T) * ((size_t)(PAIR ? 2 : 1) * kTile * kLd +
                            2 * (size_t)kTile * P + 2 * kTile +
                            kWarps * kVals + 2 * NQ) +
               sizeof(int) * (4 * NQ + 1);
    }
};

// One CTA per tile pair p: partial slots 2p (G[I, J], to (out I, out J))
// and, on the pair path, 2p + 1 (G[J, I], to (out J, out I)), each
// (Q, 3) in part; this launch writes its q's [q0, q0 + NQ). Two CTAs an
// SM (at most 128 registers a thread) but for float64 pair launches of
// more than six kernels, whose 6 * NQ accumulators need more.
template <typename T, int NQ, bool PAIR>
__global__ void __launch_bounds__(
    kThreads, (PAIR && NQ > 6 && sizeof(T) == 8) ? 1 : 2)
k7_bwd_tile_kernel(const T* __restrict__ G, const T* __restrict__ xa,
                   const T* __restrict__ xb, const T* __restrict__ alpha,
                   const int* __restrict__ kinds,
                   const int* __restrict__ masks, const T* __restrict__ prm,
                   const int* __restrict__ ta, const int* __restrict__ tb,
                   const int* __restrict__ pairs, T* __restrict__ part,
                   int64_t ldg, int P, int Q, int q0, int gt) {
    using Cfg = TileCfg<T, NQ, PAIR>;
    constexpr int kVals = Cfg::kVals;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* As = reinterpret_cast<T*>(smem_raw);
    T* Bs = As + kTile * kLd;                 // pair path only
    T* xr = Bs + (PAIR ? kTile * kLd : 0);
    T* xc = xr + kTile * P;
    T* ar = xc + kTile * P;
    T* ac = ar + kTile;
    T* red = ac + kTile;
    T* sgam = red + kWarps * kVals;
    T* sper = sgam + NQ;
    int* skind = reinterpret_cast<int*>(sper + NQ);
    int* smask = skind + NQ;
    int* sfirst = smask + NQ;
    int* sneedr = sfirst + NQ;
    int* srbf = sneedr + NQ;

    const int tid = threadIdx.x;
    const int p = blockIdx.x;
    const int I = pairs[2 * p], J = pairs[2 * p + 1];
    const int r0 = ta[3 * I], rl = ta[3 * I + 1];
    const int c0 = tb[3 * J], cl = tb[3 * J + 1];

    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
        const int r = idx / kTile, c = idx % kTile;
        const bool v = r < rl && c < cl;
        runlmc::cp_async_elem(
            As + r * kLd + c, v ? G + (int64_t)(r0 + r) * ldg + c0 + c : G,
            v);
        if (PAIR) {  // Bs[b][a] = G[c0 + b, r0 + a]
            const bool w = r < cl && c < rl;
            runlmc::cp_async_elem(
                Bs + r * kLd + c,
                w ? G + (int64_t)(c0 + r) * ldg + r0 + c : G, w);
        }
    }
    for (int idx = tid; idx < kTile * P; idx += kThreads) {
        const int r = idx / P;
        xr[idx] = r < rl ? xa[(int64_t)r0 * P + idx] : T(0);
        xc[idx] = r < cl ? xb[(int64_t)c0 * P + idx] : T(0);
    }
    if (tid < kTile) {
        ar[tid] = alpha != nullptr && tid < rl ? alpha[r0 + tid] : T(0);
        ac[tid] = alpha != nullptr && tid < cl ? alpha[c0 + tid] : T(0);
    }
    if (tid < NQ) {
        const int q = q0 + tid;
        skind[tid] = kinds[q];
        smask[tid] = masks[q];
        sgam[tid] = prm[3 * q];
        sper[tid] = prm[3 * q + 1];
    }
    __syncthreads();
    if (tid < NQ) {
        runlmc::pass_facts(skind, smask, tid, 0, NQ, sfirst[tid],
                           sneedr[tid]);
    }
    if (tid == 0) *srbf = runlmc::one_mask_rbf(skind, smask, 0, NQ);
    runlmc::cp_async_commit();
    runlmc::cp_async_wait_all();
    __syncthreads();

    const int c = tid % kTile;
    const int rb = tid / kTile;
    const bool diag = PAIR && I == J;
    const bool has_alpha = alpha != nullptr;
    const bool one_rbf = *srbf != 0;
    T acc[kVals];
#pragma unroll
    for (int t = 0; t < kVals; ++t) acc[t] = T(0);
    for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rb + (kThreads / kTile) * i;
        if (r >= rl || c >= cl || (diag && r < c)) continue;
        T g1 = As[r * kLd + c];
        T g2 = PAIR ? Bs[c * kLd + r] : T(0);
        if (PAIR && gt) {  // G came column-major: the tiles hold G^T
            const T t = g1;
            g1 = g2;
            g2 = t;
        }
        if (has_alpha) {
            g1 = sub_prod(g1, ar[r], ac[c]);
            g2 = sub_prod(g2, ar[r], ac[c]);
        }
        if (diag && r == c) g2 = T(0);
        if (one_rbf) {  // no branch between the kernels: their exps overlap
            const T d2 = runlmc::sq_dist<T>(smask[0], xr + r * P,
                                            xc + c * P, P);
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) {
                const T k = runlmc::dexp(T(-0.5) * d2 * sgam[qq]);
                const T dg = T(-0.5) * d2 * k;
                acc[3 * qq] += g1 * k;
                acc[3 * qq + 1] += g1 * dg;
                if (PAIR) {
                    acc[3 * NQ + 3 * qq] += g2 * k;
                    acc[3 * NQ + 3 * qq + 1] += g2 * dg;
                }
            }
            continue;
        }
        // each distinct mask's distance once, for the kernels that share it
        for (int f = 0; f < NQ; ++f) {
            if (sfirst[f] != f) continue;
            const T d2 = runlmc::sq_dist<T>(smask[f], xr + r * P,
                                            xc + c * P, P);
            const T rr = sneedr[f] ? runlmc::dsqrt(d2) : T(0);
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) {
                if (sfirst[qq] != f) continue;
                const int kind = skind[qq];
                T k, dg, dp;
                runlmc::kern_grads_d2<T>(kind, d2, rr, sgam[qq], sper[qq], k,
                                         dg, dp);
                acc[3 * qq] += g1 * k;
                acc[3 * qq + 1] += g1 * dg;
                if (kind == runlmc::kStdPeriodic) acc[3 * qq + 2] += g1 * dp;
                if (PAIR) {
                    acc[3 * NQ + 3 * qq] += g2 * k;
                    acc[3 * NQ + 3 * qq + 1] += g2 * dg;
                    if (kind == runlmc::kStdPeriodic) {
                        acc[3 * NQ + 3 * qq + 2] += g2 * dp;
                    }
                }
            }
        }
    }
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int t = 0; t < kVals; ++t) {
        T v = acc[t];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == 0) red[warp * kVals + t] = v;
    }
    __syncthreads();
    if (tid < kVals) {
        T s = 0;
        for (int w = 0; w < kWarps; ++w) s += red[w * kVals + tid];
        const int dir = tid / (3 * NQ);
        const int rem = tid - dir * 3 * NQ;
        part[(((int64_t)p * 2 + dir) * Q + q0) * 3 + rem] = s;
    }
}

// One CTA per (d, e, q): S[q, k, d, e] from the partial slots the plan
// lists for (d, e) (ptr / idx, CSR over d * D + e, slots ascending):
// threads stride over them, then a fixed butterfly and a fixed pass over
// the warps. The last CTA (a ticket, which only picks who finishes) forms
// dB and the table's cotangent, a warp per q over the (d, e).
template <typename T>
__global__ void __launch_bounds__(kFinThreads)
k7_bwd_finish_kernel(const T* __restrict__ part, const int* __restrict__ ptr,
                     const int* __restrict__ idx, const T* __restrict__ B,
                     const T* __restrict__ prm, T* __restrict__ S,
                     int* __restrict__ ticket, T* __restrict__ dB,
                     T* __restrict__ dprm, int Q, int D) {
    constexpr int kFinWarps = kFinThreads / 32;
    __shared__ T red[3][kFinWarps];
    __shared__ bool last;
    const int dd = D * D;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int de = blockIdx.x / Q, q = blockIdx.x - (blockIdx.x / Q) * Q;
    T s0 = 0, s1 = 0, s2 = 0;
    const int end = ptr[de + 1];
#pragma unroll 4
    for (int j = ptr[de] + tid; j < end; j += kFinThreads) {
        const T* v = part + ((int64_t)idx[j] * Q + q) * 3;
        s0 += v[0];
        s1 += v[1];
        s2 += v[2];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
        red[0][warp] = s0;
        red[1][warp] = s1;
        red[2][warp] = s2;
    }
    __syncthreads();
    if (tid < 3) {
        T v = 0;
        for (int w = 0; w < kFinWarps; ++w) v += red[tid][w];
        S[(q * 3 + tid) * dd + de] = v;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int it = tid; it < Q * dd; it += kFinThreads) {
        const int qq = it / dd;
        dB[it] = prm[3 * qq + 2] * __ldcg(S + (qq * 3) * dd + it - qq * dd);
    }
    for (int qq = warp; qq < Q; qq += kFinWarps) {
        T a0 = 0, a1 = 0, a2 = 0;
        for (int e = lane; e < dd; e += 32) {
            const T b = B[(int64_t)qq * dd + e];
            a0 += b * __ldcg(S + (qq * 3) * dd + e);
            a1 += b * __ldcg(S + (qq * 3 + 1) * dd + e);
            a2 += b * __ldcg(S + (qq * 3 + 2) * dd + e);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            a0 += __shfl_xor_sync(0xffffffffu, a0, off);
            a1 += __shfl_xor_sync(0xffffffffu, a1, off);
            a2 += __shfl_xor_sync(0xffffffffu, a2, off);
        }
        if (lane == 0) {
            const T scale = prm[3 * qq + 2];
            dprm[3 * qq] = scale * a1;
            dprm[3 * qq + 1] = scale * a2;
            dprm[3 * qq + 2] = a0;
        }
    }
    if (tid == 0) *ticket = 0;  // ready for the next launch
}

template <typename T, int NQ, bool PAIR>
int launch_tiles(const T* G, const T* xa, const T* xb, const T* alpha,
                 const int* kinds, const int* masks, const T* prm,
                 const int* ta, const int* tb, const int* pairs, T* part,
                 int npairs, int64_t ldg, int P, int Q, int q0, int gt,
                 cudaStream_t stream) {
    auto kern = k7_bwd_tile_kernel<T, NQ, PAIR>;
    const size_t smem = TileCfg<T, NQ, PAIR>::smem(P);
    // the opt-in past 48 KB, once per device and instantiation (the
    // largest P so far)
    static size_t opted[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (smem > 48 * 1024 && opted[dev] < smem) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        opted[dev] = smem;
    }
    kern<<<(unsigned)npairs, kThreads, smem, stream>>>(
        G, xa, xb, alpha, kinds, masks, prm, ta, tb, pairs, part, ldg, P, Q,
        q0, gt);
    return (int)cudaGetLastError();
}

template <typename T, bool PAIR>
int launch_slice(int nq, const T* G, const T* xa, const T* xb,
                 const T* alpha, const int* kinds, const int* masks,
                 const T* prm, const int* ta, const int* tb,
                 const int* pairs, T* part, int npairs, int64_t ldg, int P,
                 int Q, int q0, int gt, cudaStream_t s) {
#define K7_SLICE(N)                                                         \
    case N:                                                                 \
        return launch_tiles<T, N, PAIR>(G, xa, xb, alpha, kinds, masks,     \
                                        prm, ta, tb, pairs, part, npairs,   \
                                        ldg, P, Q, q0, gt, s);
    switch (nq) {
        K7_SLICE(1)
        K7_SLICE(2)
        K7_SLICE(3)
        K7_SLICE(4)
        K7_SLICE(5)
        K7_SLICE(6)
        K7_SLICE(7)
        K7_SLICE(8)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef K7_SLICE
}

// plan: int32 [ta (nta, 3) | tb (ntb, 3) | pairs (npairs, 2) |
// ptr (D * D + 1) | idx], as hopper/cross.py bwd_plan packs it
template <typename T>
int launch(const T* G, const T* xa, const T* xb, const T* alpha,
           const int* kinds, const int* masks, const T* prm, const T* B,
           const int* plan, int nta, int ntb, int npairs, int pair, int gt,
           T* part, T* S, int* ticket, T* dB, T* dprm, int64_t ldg, int P,
           int Q, int D, void* stream) {
    if (Q < 1 || npairs < 1 || P < 1 || P > 31) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    const int* ta = plan;
    const int* tb = ta + 3 * nta;
    const int* pairs = tb + 3 * ntb;
    const int* ptr = pairs + 2 * npairs;
    const int* idx = ptr + D * D + 1;
    for (int q0 = 0; q0 < Q; q0 += kMaxQ) {
        const int nq = Q - q0 < kMaxQ ? Q - q0 : kMaxQ;
        const int rc =
            pair ? launch_slice<T, true>(nq, G, xa, xb, alpha, kinds, masks,
                                         prm, ta, tb, pairs, part, npairs,
                                         ldg, P, Q, q0, gt, s)
                 : launch_slice<T, false>(nq, G, xa, xb, alpha, kinds, masks,
                                          prm, ta, tb, pairs, part, npairs,
                                          ldg, P, Q, q0, 0, s);
        if (rc != 0) return rc;
    }
    k7_bwd_finish_kernel<T><<<(unsigned)(D * D * Q), kFinThreads, 0, s>>>(
        part, ptr, idx, B, prm, S, ticket, dB, dprm, Q, D);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cross_kernel_bwd_f32(
    const float* G, const float* xa, const float* xb, const float* alpha,
    const int* kinds, const int* masks, const float* prm, const float* B,
    const int* plan, int nta, int ntb, int npairs, int pair, int gt,
    float* part, float* S, int* ticket, float* dB, float* dprm,
    int64_t ldg, int P, int Q, int D, void* stream) {
    return launch<float>(G, xa, xb, alpha, kinds, masks, prm, B, plan, nta,
                         ntb, npairs, pair, gt, part, S, ticket, dB, dprm,
                         ldg, P, Q, D, stream);
}

extern "C" int cross_kernel_bwd_f64(
    const double* G, const double* xa, const double* xb, const double* alpha,
    const int* kinds, const int* masks, const double* prm, const double* B,
    const int* plan, int nta, int ntb, int npairs, int pair, int gt,
    double* part, double* S, int* ticket, double* dB, double* dprm,
    int64_t ldg, int P, int Q, int D, void* stream) {
    return launch<double>(G, xa, xb, alpha, kinds, masks, prm, B, plan, nta,
                          ntb, npairs, pair, gt, part, S, ticket, dB, dprm,
                          ldg, P, Q, D, stream);
}
