// K1 (+K8) backward: the cotangent G = dL/dK_UU of one group's dense grid
// kernel (kuu_dense.cu),
//
//   K_UU[(d,i),(e,j)] = sum_q B[q,d,e] * scale_q * k~_q(dists[off(i,j)]),
//
// reduced to the cotangents of the group's kernel-table rows
// prm[q] = (gamma_q, period_q, scale_q) and of B, in three launches.
//
// 1. The offset sums of G,
//
//      H[d,e,o] = sum over (i, j) with off(i,j) = o of G[d*m + i, e*m + j],
//      off(i,j) = sum_p |c_p(i) - c_p(j)| * stride_p,
//
//    for a row-major grid of up to three dims with sizes (n0, n1, n2). G
//    is not assumed symmetric.
// 2. The reduction over the offsets o, one CTA per (q, d, e): with k~,
//    dk~/dgamma and dk~/dperiod at r_o = dists[o] (common.cuh
//    kern_grads),
//
//      S0[q,d,e] = sum_o H[d,e,o] k~_q(r_o),
//      S1[q,d,e] = sum_o H[d,e,o] dk~_q/dgamma(r_o),
//      S2[q,d,e] = sum_o H[d,e,o] dk~_q/dperiod(r_o),
//      d B[q,d,e] = scale_q S0[q,d,e];
//
//    then one thread per q sums over (d, e) in order:
//
//      d scale_q  = sum_{d,e} B[q,d,e] S0[q,d,e],
//      d gamma_q  = scale_q sum_{d,e} B[q,d,e] S1[q,d,e],
//      d period_q = scale_q sum_{d,e} B[q,d,e] S2[q,d,e].
//
// Autograd carries d prm through LMCKernelSpec.table_rows' transforms to
// the raw parameters (hopper/kuu.py).
//
// Replaces XLA's autodiff of runlmc_tpu/lmc/grid.py:535-547 (the
// transpose of the index-map gather tops[:, idx_map], a scatter-add of
// the (Q, m, m) cotangent stack through the host-built (m, m) map, after
// the einsum's transpose with B, then the elementwise chain of
// kernels/stationary.py's k(r) back to the parameters).
//
// Bound on the card: reading G once, (Dm)^2 elements (38.3 MB in f32 and
// 76.6 MB in f64 at the fx2007 grid, Dm = 3094: 11.4 and 22.9 us at
// 3.35 TB/s). H is D*D*m elements, a few hundred KB; stage 2 reads it
// Q times from L2.
//
// Design of stage 1: the pairs at offset o = (dl0, dl1, dl2) are, on each
// axis p, (a, a + dl_p) or (a + dl_p, a) for a in [0, n_p - dl_p); a sign
// pattern picks one of the two forms on every axis with dl_p > 0, so
// every pair is visited exactly once over the patterns, on 2-D and 3-D
// grids too. One block covers kOTile offsets (threadIdx.x) of one (d, e)
// block of G (blockIdx.y) with kSlices threads per offset (threadIdx.y),
// each walking a contiguous slice of a0 for every pattern in a fixed
// order. The slices' partial sums meet in shared memory and are added in
// a fixed order. Neighbouring threads take neighbouring offsets, so the
// (a, a + dl) reads of a warp are coalesced along a row; the (a + dl, a)
// reads step down a column and find the next a's sector in L1.
// Stage 2: each CTA's threads stride over o and meet in a fixed
// shared-memory tree; the Q threads of the last step read S in (d, e)
// order. No atomics anywhere: the same result on every run.

#include "common.cuh"

namespace {

constexpr int kOTile = 32;
constexpr int kSlices = 8;

template <typename T>
__global__ void kuu_dense_bwd_kernel(const T* __restrict__ G,
                                     T* __restrict__ H, int D, int m,
                                     int n0, int n1, int n2) {
    __shared__ T part[kSlices][kOTile];
    const int o = blockIdx.x * kOTile + threadIdx.x;
    const int de = blockIdx.y;  // d * D + e
    const int d = de / D;
    const int e = de - d * D;
    T acc = 0;
    if (o < m) {
        const int64_t dm = (int64_t)D * m;
        const int stride0 = n1 * n2;
        const int dl0 = o / stride0, dl1 = (o / n2) % n1, dl2 = o % n2;
        // block (d, e) of G; element (i, j) at Gb[i * dm + j]
        const T* Gb = G + (int64_t)d * m * dm + (int64_t)e * m;
        const int len0 = n0 - dl0, len1 = n1 - dl1, len2 = n2 - dl2;
        const int chunk = (len0 + kSlices - 1) / kSlices;
        const int a0_lo = threadIdx.y * chunk;
        const int a0_hi = min(len0, a0_lo + chunk);
        for (int pat = 0; pat < 8; ++pat) {
            const bool f0 = pat & 1, f1 = pat & 2, f2 = pat & 4;
            if ((f0 && dl0 == 0) || (f1 && dl1 == 0) || (f2 && dl2 == 0)) {
                continue;
            }
            // a flipped axis puts the larger coordinate on the row side
            const int si0 = f0 ? dl0 : 0, sj0 = f0 ? 0 : dl0;
            const int si1 = f1 ? dl1 : 0, sj1 = f1 ? 0 : dl1;
            const int si2 = f2 ? dl2 : 0, sj2 = f2 ? 0 : dl2;
            for (int a0 = a0_lo; a0 < a0_hi; ++a0) {
                for (int a1 = 0; a1 < len1; ++a1) {
                    const int i = ((a0 + si0) * n1 + a1 + si1) * n2 + si2;
                    const int j = ((a0 + sj0) * n1 + a1 + sj1) * n2 + sj2;
                    // (i + a2, j + a2) for a2 in [0, len2): one step is
                    // one row down and one column right
                    const T* p = Gb + (int64_t)i * dm + j;
                    for (int a2 = 0; a2 < len2; ++a2) {
                        acc += p[(int64_t)a2 * (dm + 1)];
                    }
                }
            }
        }
    }
    part[threadIdx.y][threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.y == 0 && o < m) {
        T s = 0;
        for (int k = 0; k < kSlices; ++k) s += part[k][threadIdx.x];
        H[(int64_t)de * m + o] = s;
    }
}

constexpr int kRedThreads = 256;

// the sum of every thread's v over the CTA, by a fixed tree
template <typename T>
__device__ T block_sum(T v, T* red) {
    red[threadIdx.x] = v;
    __syncthreads();
    for (int s = kRedThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    const T out = red[0];
    __syncthreads();
    return out;
}

// One block per (q, d, e): S[q,d,e,0:3] and d B[q,d,e].
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
kuu_table_bwd_kernel(runlmc::KindTable kinds, const T* __restrict__ prm,
                     const T* __restrict__ dists, const T* __restrict__ H,
                     T* __restrict__ S, T* __restrict__ dB, int D, int m) {
    __shared__ T red[kRedThreads];
    const int dd = D * D;
    const int idx = blockIdx.x;  // q * D^2 + d * D + e
    const int q = idx / dd;
    const T* p = prm + q * 3;
    const T* Hde = H + (int64_t)(idx - q * dd) * m;
    T s0 = 0, s1 = 0, s2 = 0;
    for (int o = threadIdx.x; o < m; o += kRedThreads) {
        T k, dg, dp;
        runlmc::kern_grads<T>(kinds.kind[q], dists[o], p[0], p[1], k, dg,
                              dp);
        const T h = Hde[o];
        s0 += h * k;
        s1 += h * dg;
        s2 += h * dp;
    }
    s0 = block_sum(s0, red);
    s1 = block_sum(s1, red);
    s2 = block_sum(s2, red);
    if (threadIdx.x == 0) {
        S[idx * 3] = s0;
        S[idx * 3 + 1] = s1;
        S[idx * 3 + 2] = s2;
        dB[idx] = p[2] * s0;
    }
}

// One thread per q: the table's cotangent from S, summed in (d, e) order.
template <typename T>
__global__ void kuu_table_finish_kernel(const T* __restrict__ prm,
                                        const T* __restrict__ B,
                                        const T* __restrict__ S,
                                        T* __restrict__ dprm, int Q, int D) {
    const int q = threadIdx.x;
    if (q >= Q) return;
    const int dd = D * D;
    T a0 = 0, a1 = 0, a2 = 0;
    for (int de = 0; de < dd; ++de) {
        const T b = B[(int64_t)q * dd + de];
        const T* s = S + ((int64_t)q * dd + de) * 3;
        a0 += b * s[0];
        a1 += b * s[1];
        a2 += b * s[2];
    }
    const T scale = prm[q * 3 + 2];
    dprm[q * 3] = scale * a1;
    dprm[q * 3 + 1] = scale * a2;
    dprm[q * 3 + 2] = a0;
}

template <typename T>
int launch(const int* kinds_host, const T* prm, const T* dists, const T* B,
           const T* G, T* H, T* S, T* dprm, T* dB, int Q, int D, int m,
           int n0, int n1, int n2, void* stream) {
    if (Q < 1 || Q > runlmc::kMaxTableQ || m < 1) {
        return (int)cudaErrorInvalidValue;
    }
    runlmc::KindTable kinds;
    for (int q = 0; q < Q; ++q) kinds.kind[q] = kinds_host[q];
    dim3 block(kOTile, kSlices);
    dim3 grid((unsigned)((m + kOTile - 1) / kOTile), (unsigned)(D * D));
    kuu_dense_bwd_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        G, H, D, m, n0, n1, n2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kuu_table_bwd_kernel<T>
        <<<(unsigned)(Q * D * D), kRedThreads, 0, (cudaStream_t)stream>>>(
            kinds, prm, dists, H, S, dB, D, m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kuu_table_finish_kernel<T>
        <<<1, runlmc::kMaxTableQ, 0, (cudaStream_t)stream>>>(prm, B, S, dprm,
                                                              Q, D);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kuu_dense_bwd_f32(const int* kinds, const float* prm,
                                 const float* dists, const float* B,
                                 const float* G, float* H, float* S,
                                 float* dprm, float* dB, int Q, int D, int m,
                                 int n0, int n1, int n2, void* stream) {
    return launch<float>(kinds, prm, dists, B, G, H, S, dprm, dB, Q, D, m,
                         n0, n1, n2, stream);
}

extern "C" int kuu_dense_bwd_f64(const int* kinds, const double* prm,
                                 const double* dists, const double* B,
                                 const double* G, double* H, double* S,
                                 double* dprm, double* dB, int Q, int D,
                                 int m, int n0, int n1, int n2,
                                 void* stream) {
    return launch<double>(kinds, prm, dists, B, G, H, S, dprm, dB, Q, D, m,
                          n0, n1, n2, stream);
}
