// K8 on the fft groups' first rows: the kernels' k(r) on a grid's first
// row, written straight into the symmetric circulant embedding that the
// Fourier symbol's rfftn (cuFFT, K11) reads, and its backward.
//
//   forward   E[q, e] = scale_q k~_q(dists[src(e)]), 0 where src(e) is
//             none: on each grid axis p of size n_p, embedded in
//             E_p = next_pow2(2 n_p) points, position e_p maps to
//             e_p (e_p < n_p), E_p - e_p (e_p > E_p - n_p), else none,
//             i.e. [t_0..t_{n-1}, 0...0, t_{n-1}..t_1] on every axis;
//   backward  t-bar_q[o] = the sum of E-bar[q, e] over the images e of
//             the first-row position o (2 per axis where o_p > 0, 1
//             where o_p = 0), then the table's cotangent
//             [d gamma, d period, d scale]_q = sum_o t-bar_q[o]
//             [scale_q dk~/dgamma, scale_q dk~/dperiod, k~](dists[o]).
//
// Replaces the fft branch of runlmc_tpu/lmc/grid.py:535 (build_group_state:
// eval_kernels_stacked, the elementwise k(r) of kernels/stationary.py:
// 64-157, then ops/bttb.py:54 cyclic_extend before the rfftn of :86
// bttb_fft) and XLA's autodiff of both. k~ is common.cuh's kern_eval /
// kern_grads, so it rounds as K1 and K7 round it.
//
// Bound on the card: bytes, the Q x prod(E_p) embedding written once
// (the m distances and the table read once); a few tens of operations per
// first-row point and kernel. The launches are what it saves: the torch
// version runs a handful of elementwise kernels per kernel q and a flip,
// a zero fill and a concat per axis, forward and backward.
//
// Design: the forward is one thread per embedded element (a grid-stride
// loop), which evaluates k(r) where its position has a source. The
// backward keeps the order of its sums fixed: thread t of 256 walks the
// first-row points o = t, t + 256, ... in turn with three running sums
// (acc += w * k), then a fixed xor-shuffle tree in each warp and a fixed
// pass over the warps: no atomics, a second launch is bit-identical.
// Where a kernel q's terms fit in the shared memory of a thread-block
// cluster (the wrapper's bwd_cluster: C = 8 CTAs a q at the weather
// group), the cluster kernel spreads that work and keeps its order: CTA r
// takes the chains of warps [8 r / C, 8 (r + 1) / C), computes all their
// points' terms at once (the images' sum w in the (a, b, c) order and
// kern_grads' k, dk/dgamma, dk/dperiod; 512 threads, one point each at
// the weather group) into its own shared memory, runs those chains and
// their warps' shuffle trees, and stores each warp's three sums into
// rank 0's shared memory with st.async (cluster.cuh); rank 0 adds the 8
// warps' sums in order. So dprm has the one-CTA kernel's bits, and only
// 24 values cross between CTAs. Larger q's (bwd_cluster 0) take the
// one-CTA kernel.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// a CTA's dynamic shared memory without an opt-in, less 1 KB for its
// static shared memory
constexpr size_t kSmemLimit = 47 * 1024;
// the cluster kernel's CTA threads (its points' terms; kThreads / C of
// them then run the chains)
constexpr int kClusterThreads = 512;

// the first-row index of embedded position e on an axis (n, E), or -1
__device__ __forceinline__ int src_of(int e, int n, int E) {
    if (e < n) return e;
    if (e > E - n) return E - e;
    return -1;
}

template <typename T>
__global__ void rows_fft_kernel(runlmc::KindTable kinds,
                                const T* __restrict__ prm,
                                const T* __restrict__ dists,
                                T* __restrict__ out, int Q, int n0, int n1,
                                int n2, int E0, int E1, int E2) {
    const int64_t per_q = (int64_t)E0 * E1 * E2;
    const int64_t total = per_q * Q;
    for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
        const int q = (int)(idx / per_q);
        int64_t rem = idx - (int64_t)q * per_q;
        const int e2 = (int)(rem % E2);
        rem /= E2;
        const int e1 = (int)(rem % E1);
        const int e0 = (int)(rem / E1);
        const int s0 = src_of(e0, n0, E0), s1 = src_of(e1, n1, E1),
                  s2 = src_of(e2, n2, E2);
        T v = T(0);
        if (s0 >= 0 && s1 >= 0 && s2 >= 0) {
            const T r = dists[((int64_t)s0 * n1 + s1) * n2 + s2];
            v = prm[q * 3 + 2] * runlmc::kern_eval<T>(
                                     kinds.kind[q], r, prm[q * 3],
                                     prm[q * 3 + 1]);
        }
        out[idx] = v;
    }
}

// the image positions of source index s on an axis (n, E): e = s, and
// E - s where 0 < s (s < n always)
__device__ __forceinline__ int images_of(int s, int E, int* e) {
    e[0] = s;
    if (s > 0) {
        e[1] = E - s;
        return 2;
    }
    return 1;
}

// the images' sum w of first-row point o in the (a, b, c) order, and
// kern_grads there
template <typename T>
__device__ __forceinline__ void point_terms(int kind, const T* Gq,
                                            const T* dists, int o, int n0,
                                            int n1, int n2, int E0, int E1,
                                            int E2, T gamma, T period, T& w,
                                            T& k, T& dg, T& dp) {
    const int s2 = o % n2;
    const int s1 = (o / n2) % n1;
    const int s0 = o / (n1 * n2);
    int i0[2], i1[2], i2[2];
    const int c0 = images_of(s0, E0, i0), c1 = images_of(s1, E1, i1),
              c2 = images_of(s2, E2, i2);
    w = T(0);
    for (int a = 0; a < c0; ++a)
        for (int b = 0; b < c1; ++b)
            for (int c = 0; c < c2; ++c)
                w += Gq[((int64_t)i0[a] * E1 + i1[b]) * E2 + i2[c]];
    runlmc::kern_grads<T>(kind, dists[o], gamma, period, k, dg, dp);
}

template <typename T>
__global__ void rows_fft_bwd_kernel(runlmc::KindTable kinds,
                                    const T* __restrict__ prm,
                                    const T* __restrict__ dists,
                                    const T* __restrict__ G,
                                    T* __restrict__ dprm, int n0, int n1,
                                    int n2, int E0, int E1, int E2) {
    __shared__ T red[kWarps][3];
    const int q = blockIdx.x;
    const int kind = kinds.kind[q];
    const T gamma = prm[q * 3], period = prm[q * 3 + 1];
    const T scale = prm[q * 3 + 2];
    const int64_t per_q = (int64_t)E0 * E1 * E2;
    const T* Gq = G + (int64_t)q * per_q;
    const int m = n0 * n1 * n2;
    T acc0 = T(0), acc1 = T(0), acc2 = T(0);
    for (int o = threadIdx.x; o < m; o += kThreads) {
        T w, k, dg, dp;
        point_terms<T>(kind, Gq, dists, o, n0, n1, n2, E0, E1, E2, gamma,
                       period, w, k, dg, dp);
        acc0 += w * k;
        acc1 += w * dg;
        acc2 += w * dp;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
        acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
        acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        red[warp][0] = acc0;
        red[warp][1] = acc1;
        red[warp][2] = acc2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        T s0 = T(0), s1 = T(0), s2 = T(0);
        for (int w = 0; w < kWarps; ++w) {
            s0 += red[w][0];
            s1 += red[w][1];
            s2 += red[w][2];
        }
        dprm[q * 3] = scale * s1;
        dprm[q * 3 + 1] = scale * s2;
        dprm[q * 3 + 2] = s0;
    }
}

// the cluster kernel: a cluster of C CTAs per kernel q (grid (C, Q), C
// in 1, 2, 4, 8), CTA r holding the chains t in [r T, (r + 1) T), T =
// kThreads / C, of the one-CTA kernel: it computes their points' terms w,
// k, dk/dgamma, dk/dperiod into its shared memory (four arrays of J x T,
// point t + kThreads j at [j][t - r T], J = ceil(m / kThreads)), runs
// the chains and their warps' shuffle trees, and stores each warp's three
// sums into rank 0's red with st.async; rank 0 sums the warps in order
template <typename T>
__global__ void __launch_bounds__(kClusterThreads)
    rows_fft_bwd_cluster_kernel(runlmc::KindTable kinds,
                                const T* __restrict__ prm,
                                const T* __restrict__ dists,
                                const T* __restrict__ G,
                                T* __restrict__ dprm, int n0, int n1, int n2,
                                int E0, int E1, int E2) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* terms = reinterpret_cast<T*>(smem_raw);
    __shared__ T red[kWarps][3];
    __shared__ uint64_t full;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    if (rank == 0 && threadIdx.x == 0) {
        runlmc::mbar_init(&full, 1);
        runlmc::fence_mbar_init();
        runlmc::mbar_expect_tx(&full, kWarps * 3 * (int)sizeof(T));
    }
    runlmc::cluster_arrive_relaxed();
    const int q = blockIdx.y;
    const int kind = kinds.kind[q];
    const T gamma = prm[q * 3], period = prm[q * 3 + 1];
    const int64_t per_q = (int64_t)E0 * E1 * E2;
    const T* Gq = G + (int64_t)q * per_q;
    const int m = n0 * n1 * n2;
    const int chains = kThreads / C;
    const int t0 = rank * chains;
    const int J = (m + kThreads - 1) / kThreads;
    const int slots = J * chains;
    for (int p = threadIdx.x; p < slots; p += kClusterThreads) {
        const int j = p / chains;
        const int o = t0 + (p - j * chains) + kThreads * j;
        if (o < m) {
            T w, k, dg, dp;
            point_terms<T>(kind, Gq, dists, o, n0, n1, n2, E0, E1, E2, gamma,
                           period, w, k, dg, dp);
            terms[p] = w;
            terms[slots + p] = k;
            terms[2 * slots + p] = dg;
            terms[3 * slots + p] = dp;
        }
    }
    __syncthreads();
    if ((int)threadIdx.x < chains) {
        // chain t = t0 + threadIdx.x: the one-CTA kernel's thread t
        T acc0 = T(0), acc1 = T(0), acc2 = T(0);
        const int t = t0 + threadIdx.x;
        for (int j = 0, p = threadIdx.x; t + kThreads * j < m;
             ++j, p += chains) {
            const T w = terms[p];
            acc0 += w * terms[slots + p];
            acc1 += w * terms[2 * slots + p];
            acc2 += w * terms[3 * slots + p];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
            acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
            acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
        }
        // every CTA of the cluster has started, rank 0's mbarrier is set
        runlmc::cluster_wait();
        if ((threadIdx.x & 31) == 0) {
            T* slot = red[t >> 5];
            runlmc::st_async(slot, acc0, &full, 0);
            runlmc::st_async(slot + 1, acc1, &full, 0);
            runlmc::st_async(slot + 2, acc2, &full, 0);
        }
    } else {
        runlmc::cluster_wait();
    }
    if (rank == 0 && threadIdx.x == 0) {
        runlmc::mbar_wait(&full, 0);
        T s0 = T(0), s1 = T(0), s2 = T(0);
        for (int w = 0; w < kWarps; ++w) {
            s0 += red[w][0];
            s1 += red[w][1];
            s2 += red[w][2];
        }
        const T scale = prm[q * 3 + 2];
        dprm[q * 3] = scale * s1;
        dprm[q * 3 + 1] = scale * s2;
        dprm[q * 3 + 2] = s0;
    }
}

runlmc::KindTable table_of(const int* kinds_host, int Q) {
    runlmc::KindTable kinds;
    for (int q = 0; q < Q; ++q) kinds.kind[q] = kinds_host[q];
    return kinds;
}

bool sizes_ok(int Q, int n0, int n1, int n2, int E0, int E1, int E2) {
    if (Q < 1 || Q > runlmc::kMaxTableQ) return false;
    const int n[3] = {n0, n1, n2}, E[3] = {E0, E1, E2};
    for (int p = 0; p < 3; ++p) {
        if (n[p] < 1 || E[p] < n[p] || (n[p] > 1 && E[p] < 2 * n[p] - 1))
            return false;
    }
    return true;
}

template <typename T>
int forward(const int* kinds_host, const T* prm, const T* dists, T* out,
            int Q, int n0, int n1, int n2, int E0, int E1, int E2,
            void* stream) {
    if (!sizes_ok(Q, n0, n1, n2, E0, E1, E2))
        return (int)cudaErrorInvalidValue;
    const int64_t total = (int64_t)E0 * E1 * E2 * Q;
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 65535) blocks = 65535;
    rows_fft_kernel<T><<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        table_of(kinds_host, Q), prm, dists, out, Q, n0, n1, n2, E0, E1, E2);
    return (int)cudaGetLastError();
}

// C = 0: the one-CTA kernel; C in 1, 2, 4, 8: the cluster kernel with
// kThreads / C chains a CTA
template <typename T>
int backward(const int* kinds_host, const T* prm, const T* dists,
             const T* G, T* dprm, int Q, int n0, int n1, int n2, int E0,
             int E1, int E2, int C, void* stream) {
    if (!sizes_ok(Q, n0, n1, n2, E0, E1, E2) ||
        (C != 0 && C != 1 && C != 2 && C != 4 && C != 8))
        return (int)cudaErrorInvalidValue;
    if (C == 0) {
        rows_fft_bwd_kernel<T><<<Q, kThreads, 0, (cudaStream_t)stream>>>(
            table_of(kinds_host, Q), prm, dists, G, dprm, n0, n1, n2, E0,
            E1, E2);
        return (int)cudaGetLastError();
    }
    const int m = n0 * n1 * n2;
    const size_t smem = (size_t)4 * ((m + kThreads - 1) / kThreads) *
                        (kThreads / C) * sizeof(T);
    if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C, (unsigned)Q, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, rows_fft_bwd_cluster_kernel<T>, table_of(kinds_host, Q), prm,
        dists, G, dprm, n0, n1, n2, E0, E1, E2);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

#define ROWS_FFT_ENTRIES(T, SFX)                                              \
    extern "C" int kern_rows_fft_##SFX(const int* kinds, const T* prm,        \
                                       const T* dists, T* out, int Q, int n0, \
                                       int n1, int n2, int E0, int E1,        \
                                       int E2, void* stream) {                \
        return forward<T>(kinds, prm, dists, out, Q, n0, n1, n2, E0, E1, E2,  \
                          stream);                                            \
    }                                                                         \
    extern "C" int kern_rows_fft_bwd_##SFX(                                   \
        const int* kinds, const T* prm, const T* dists, const T* G, T* dprm,  \
        int Q, int n0, int n1, int n2, int E0, int E1, int E2, int C,         \
        void* stream) {                                                       \
        return backward<T>(kinds, prm, dists, G, dprm, Q, n0, n1, n2, E0, E1, \
                           E2, C, stream);                                    \
    }

ROWS_FFT_ENTRIES(float, f32)
ROWS_FFT_ENTRIES(double, f64)
