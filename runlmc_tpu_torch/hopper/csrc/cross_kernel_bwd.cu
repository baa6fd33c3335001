// K7 backward: the parameter cotangents of the dense LMC cross-covariance
// (cross_kernel.cu) from the cotangent G = dL/dK (na, nb),
//
//   K[a,b] = sum_q B[q, oa[a], ob[b]] * scale_q * k~_q(r_q(a,b)),
//
// reduced per q into three per-row tables over the column's output e,
//
//   part[a, e, q, 0] = sum_{b: ob[b] = e} G[a,b] k~_q(r)
//   part[a, e, q, 1] = sum_{b: ob[b] = e} G[a,b] dk~_q/dgamma
//   part[a, e, q, 2] = sum_{b: ob[b] = e} G[a,b] dk~_q/dperiod
//
// (k~ the unscaled kernel). With a vector alpha (na = nb) the kernel reads
// G[a,b] - alpha_a alpha_b in place of G[a,b]: the exact oracle's
// gradient hands it K^-1 and alpha = K^-1 y (lmc/likelihood.py
// ExactMLL), so the rank-1 term of 1/2 (K^-1 - alpha alpha^T) is formed
// in the loads and never stored. The wrapper (hopper/cross.py) sums the rows
// of each output d = oa[a] by a one-hot product into S0, S1, S2
// (Q, D, D) and finishes with dB_q = scale_q S0_q, dscale_q = <B_q, S0_q>,
// dgamma_q = scale_q <B_q, S1_q>, dperiod_q = scale_q <B_q, S2_q>.
//
// Replaces XLA's autodiff of runlmc_tpu/lmc/likelihood.py:85-96 inside
// jax.grad of exact_mll, which keeps a distance tensor per active-dim
// group and a gathered (na, nb) coregionalization scale per q and runs
// their transposes. Here each element's distance and k~_q(r) are
// recomputed from the inputs: no (Q, na, nb) stack is stored or loaded.
//
// Bound on the card: reading G once, na * nb elements (77.5 MB in f64 at
// the fx2007 shape (3113, 3113): 23 us at 3.35 TB/s; 1.99 GB at the
// weather shape (15768, 15768): 594 us), unless the Q exp / sin / cos
// evaluations per element set it (weather: Q = 6).
//
// Design: one warp per (row a, column output e). The columns are visited
// in the order of a stable sort by output (perm, with segment bounds
// seg[e]); for the model's own data, stacked by output, perm is the
// identity and a warp's reads of row a are coalesced. Each lane keeps
// 3 * kMaxQ accumulators in registers (q unrolled, so the indices are
// static), strides over its segment, and the warp reduces them by a
// fixed butterfly of shuffles; lane 0 writes the row's partials. The
// order of every sum is fixed: the same result on every run, no atomics.
// More than kMaxQ kernels run as several launches over slices of q.

#include "common.cuh"

namespace {

constexpr int kMaxQ = 8;
constexpr int kWarps = 4;  // warps per block

template <typename T>
__global__ void cross_kernel_bwd_kernel(
    const T* __restrict__ G, const T* __restrict__ xa,
    const T* __restrict__ xb, const int* __restrict__ perm,
    const int* __restrict__ seg, const int* __restrict__ kinds,
    const int* __restrict__ masks, const T* __restrict__ prm,
    const T* __restrict__ alpha, T* __restrict__ part, int na, int nb,
    int P, int Q, int D, int q0, int nq) {
    const int lane = threadIdx.x & 31;
    const int64_t warp =
        (int64_t)blockIdx.x * kWarps + (int64_t)(threadIdx.x >> 5);
    if (warp >= (int64_t)na * D) return;  // whole warps leave together
    const int64_t a = warp / D;
    const int e = (int)(warp - a * D);
    const T* g_row = G + a * nb;
    const T* x_row = xa + a * P;
    const T alpha_a = alpha != nullptr ? alpha[a] : T(0);
    T acc[3 * kMaxQ];
#pragma unroll
    for (int t = 0; t < 3 * kMaxQ; ++t) acc[t] = T(0);
    for (int jj = seg[e] + lane; jj < seg[e + 1]; jj += 32) {
        const int b = perm[jj];
        const T g = alpha != nullptr ? g_row[b] - alpha_a * alpha[b]
                                     : g_row[b];
        const T* x_col = xb + (int64_t)b * P;
#pragma unroll
        for (int qq = 0; qq < kMaxQ; ++qq) {
            if (qq < nq) {
                const int q = q0 + qq;
                const int mask = masks[q];
                T d2 = 0;
                for (int p = 0; p < P; ++p) {
                    if ((mask >> p) & 1) {
                        const T diff = x_row[p] - x_col[p];
                        d2 += diff * diff;
                    }
                }
                const T r = runlmc::dsqrt(d2 > T(0) ? d2 : T(0));
                T k, dg, dp;
                runlmc::kern_grads<T>(kinds[q], r, prm[q * 3],
                                      prm[q * 3 + 1], k, dg, dp);
                acc[3 * qq] += g * k;
                acc[3 * qq + 1] += g * dg;
                acc[3 * qq + 2] += g * dp;
            }
        }
    }
#pragma unroll
    for (int t = 0; t < 3 * kMaxQ; ++t) {
        if (t < 3 * nq) {  // the same on every lane: no divergence
            T v = acc[t];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                v += __shfl_xor_sync(0xffffffffu, v, off);
            }
            acc[t] = v;
        }
    }
    if (lane == 0) {
        T* out = part + ((a * D + e) * Q + q0) * 3;
#pragma unroll
        for (int qq = 0; qq < kMaxQ; ++qq) {
            if (qq < nq) {
                out[3 * qq] = acc[3 * qq];
                out[3 * qq + 1] = acc[3 * qq + 1];
                out[3 * qq + 2] = acc[3 * qq + 2];
            }
        }
    }
}

template <typename T>
int launch(const T* G, const T* xa, const T* xb, const int* perm,
           const int* seg, const int* kinds, const int* masks, const T* prm,
           const T* alpha, T* part, int na, int nb, int P, int Q, int D,
           int q0, int nq, void* stream) {
    if (nq < 1 || nq > kMaxQ) return (int)cudaErrorInvalidValue;
    const int64_t warps = (int64_t)na * D;
    const int64_t blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cross_kernel_bwd_kernel<T>
        <<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
            G, xa, xb, perm, seg, kinds, masks, prm, alpha, part, na, nb, P,
            Q, D, q0, nq);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cross_kernel_bwd_f32(const float* G, const float* xa,
                                    const float* xb, const int* perm,
                                    const int* seg, const int* kinds,
                                    const int* masks, const float* prm,
                                    const float* alpha, float* part, int na,
                                    int nb, int P, int Q, int D, int q0,
                                    int nq, void* stream) {
    return launch<float>(G, xa, xb, perm, seg, kinds, masks, prm, alpha,
                         part, na, nb, P, Q, D, q0, nq, stream);
}

extern "C" int cross_kernel_bwd_f64(const double* G, const double* xa,
                                    const double* xb, const int* perm,
                                    const int* seg, const int* kinds,
                                    const int* masks, const double* prm,
                                    const double* alpha, double* part, int na,
                                    int nb, int P, int Q, int D, int q0,
                                    int nq, void* stream) {
    return launch<double>(G, xa, xb, perm, seg, kinds, masks, prm, alpha,
                          part, na, nb, P, Q, D, q0, nq, stream);
}
