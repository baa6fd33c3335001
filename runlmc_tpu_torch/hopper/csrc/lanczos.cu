// K13: one step of batched Lanczos (the SLQ log-determinant's
// recurrence) on (B, n) rows, one launch per step. After w = K v (the
// operator; not this kernel) a step is
//
//   w1 = w - beta v_prev;   alpha = <w1, v>
//   w2 = w1 - alpha v;      beta' = ||w2||
//   alive' = alive & (beta' > eps)
//   v' = w2 / beta' on live rows, 0 after a breakdown   (into v_prev;
//        as w2 times 1 / beta', within an ulp)
//   alpha_out = alpha on live rows, 1 after;  beta_out = beta' or 0
//
// Replaces the lax.scan body of lanczos_tridiag at
// runlmc_tpu/ops/slq.py:41-52. beta' is the norm of w2 itself, never the
// expansion ||w1||^2 - 2 alpha <w1, v> + alpha^2 ||v||^2, which cancels
// where Lanczos converges and the breakdown test compares beta' with
// 1e-14.
//
// Bound on the card: bytes. The step reads w, v_prev and v once and
// writes v' once: four (B, n) arrays, 7.6 MB in float64 at (15, 15768),
// 2.3 us at 3.35 TB/s.
//
// Design: each row gets a thread-block cluster of C CTAs
// (cudaLaunchKernelEx with a cluster dimension; C from the wrapper's
// lanczos_cluster, at most the portable 8), each CTA a contiguous slice
// of the row's 16-byte vectors. Pass 1 loads w,
// v_prev and v once, forms w1 and each warp's partial <w1, v> by a fixed
// xor-shuffle tree. Lane r of each warp stores the warp's partial into
// CTA r's shared memory with st.async, counted on CTA r's mbarrier
// (cluster.cuh); each CTA waits for its C * 8 partials and sums them, in
// (rank, warp) order, by a fixed tree, so every CTA holds the same alpha and a
// relaunch is bit-identical, without atomics, a second launch or a
// cluster barrier on the critical path (the one that proves the cluster
// started is arrived at on entry and waited on after the loads). Pass 2
// forms w2 from the registers and sums ||w2||^2 the same way; pass 3
// writes v'. A slice of up to kHeld elements a thread stays in registers
// between the passes; a longer one (long rows) reads w, v_prev and v
// again from global memory in passes 2 and 3, in the same launch. Rank 0
// of each cluster writes the row's scalars. A CTA exits only after every
// store into its shared memory has landed, and no CTA reads another's
// shared memory.
//
// The scalars may be strided (columns of the caller's (B, k) alphas and
// betas) and alive_out may be alive itself: every CTA reads alive and
// beta before it sends its first partials, rank 0 writes after it has
// received the last ones.

#include <cooperative_groups.h>

#include "cluster.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// elements of w1 and of v a thread keeps in registers between passes
constexpr int kHeld = 8;

// V elements loaded or stored as one vector
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
    T x[V];
};

// the xor-shuffle tree of x over a warp, the same in every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// lane r of each warp: the warp's partial x (the same in every lane)
// into slot [rank][warp] of CTA r's parts, counted on CTA r's mbarrier
// full
template <typename T>
__device__ __forceinline__ void send_partial(T* parts, uint64_t* full, T x,
                                             int rank, int C) {
    const int lane = threadIdx.x & 31;
    if (lane < C)
        runlmc::st_async(parts + rank * kWarps + (threadIdx.x >> 5), x, full,
                         lane);
}

// the sum of the C * kWarps partials once all have arrived, the same
// bits in every thread of every CTA: lane l adds partials l and l + 32
// in (rank, warp) order, then the xor-shuffle tree (C * kWarps <= 64)
template <typename T>
__device__ __forceinline__ T received_sum(T* parts, uint64_t* full, int C) {
    runlmc::mbar_wait(full, 0);
    const int lane = threadIdx.x & 31;
    const int total = C * kWarps;
    T x = lane < total ? parts[lane] : T(0);
    if (lane + 32 < total) x += parts[lane + 32];
    return warp_sum(x);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    lanczos_step_kernel(const T* __restrict__ w, T* vp,
                        const T* __restrict__ v, const T* beta_in,
                        int ld_beta, const int* alive_in, T* alpha_out,
                        int ld_alpha, T* beta_out, int ld_bout,
                        int* alive_out, const T* __restrict__ eps, int n) {
    using P = Pack<T, V>;
    constexpr int kHeldVec = kHeld / V;
    __shared__ T parts[2][kMaxCluster * kWarps];
    __shared__ uint64_t full[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    if (threadIdx.x == 0) {
        runlmc::mbar_init(&full[0], 1);
        runlmc::mbar_init(&full[1], 1);
        runlmc::fence_mbar_init();
        runlmc::mbar_expect_tx(&full[0], C * kWarps * (int)sizeof(T));
        runlmc::mbar_expect_tx(&full[1], C * kWarps * (int)sizeof(T));
    }
    runlmc::cluster_arrive_relaxed();
    const int row = blockIdx.y;
    const int nvec = n / V;
    const int lo = (int)((int64_t)nvec * rank / C);
    const int hi = (int)((int64_t)nvec * (rank + 1) / C);
    const int64_t base = (int64_t)row * n;
    const P* wr = reinterpret_cast<const P*>(w + base);
    P* vpr = reinterpret_cast<P*>(vp + base);
    const P* vr = reinterpret_cast<const P*>(v + base);
    const T beta = beta_in[(int64_t)row * ld_beta];
    const bool live = alive_in[row] != 0;
    const T epsv = eps[0];
    const bool held = hi - lo <= kHeldVec * kThreads;

    // pass 1: w1 = w - beta v_prev, the partial <w1, v>
    P w1[kHeldVec], vh[kHeldVec];
    T acc = T(0);
    if (held) {
#pragma unroll
        for (int k = 0; k < kHeldVec; ++k) {
            const int i = lo + threadIdx.x + k * kThreads;
            if (i < hi) {
                P a = wr[i];
                const P b = vpr[i], c = vr[i];
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    a.x[e] = a.x[e] - beta * b.x[e];
                    acc += a.x[e] * c.x[e];
                }
                w1[k] = a;
                vh[k] = c;
            }
        }
    } else {
        for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
            const P a = wr[i], b = vpr[i], c = vr[i];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const T x = a.x[e] - beta * b.x[e];
                acc += x * c.x[e];
            }
        }
    }
    // every CTA of the cluster has started and initialised its mbarriers
    runlmc::cluster_wait();
    send_partial(parts[0], &full[0], warp_sum(acc), rank, C);
    const T alpha = received_sum(parts[0], &full[0], C);

    // pass 2: w2 = w1 - alpha v, the partial ||w2||^2
    acc = T(0);
    if (held) {
#pragma unroll
        for (int k = 0; k < kHeldVec; ++k) {
            const int i = lo + threadIdx.x + k * kThreads;
            if (i < hi) {
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    const T x = w1[k].x[e] - alpha * vh[k].x[e];
                    w1[k].x[e] = x;
                    acc += x * x;
                }
            }
        }
    } else {
        for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
            const P a = wr[i], b = vpr[i], c = vr[i];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const T x = (a.x[e] - beta * b.x[e]) - alpha * c.x[e];
                acc += x * x;
            }
        }
    }
    send_partial(parts[1], &full[1], warp_sum(acc), rank, C);
    const T beta_n = runlmc::dsqrt(received_sum(parts[1], &full[1], C));

    // pass 3: the breakdown mask and v' into v_prev's storage
    const bool live_n = live && beta_n > epsv;
    // one division a thread, then products (within an ulp of w2 / beta')
    const T inv = T(1) / (beta_n > T(0) ? beta_n : T(1));
    if (held) {
#pragma unroll
        for (int k = 0; k < kHeldVec; ++k) {
            const int i = lo + threadIdx.x + k * kThreads;
            if (i < hi) {
                P o;
#pragma unroll
                for (int e = 0; e < V; ++e)
                    o.x[e] = live_n ? w1[k].x[e] * inv : T(0);
                vpr[i] = o;
            }
        }
    } else {
        for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
            const P a = wr[i], b = vpr[i], c = vr[i];
            P o;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const T x = (a.x[e] - beta * b.x[e]) - alpha * c.x[e];
                o.x[e] = live_n ? x * inv : T(0);
            }
            vpr[i] = o;
        }
    }
    if (rank == 0 && threadIdx.x == 0) {
        alpha_out[(int64_t)row * ld_alpha] = live ? alpha : T(1);
        beta_out[(int64_t)row * ld_bout] = live_n ? beta_n : T(0);
        alive_out[row] = live_n ? 1 : 0;
    }
}

template <typename T, int V>
int launch(const T* w, T* vp, const T* v, const T* beta, int ld_beta,
           const int* alive, T* alpha_out, int ld_alpha, T* beta_out,
           int ld_bout, int* alive_out, const T* eps, int B, int n, int C,
           void* stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C, (unsigned)B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, lanczos_step_kernel<T, V>, w, vp, v, beta, ld_beta, alive,
        alpha_out, ld_alpha, beta_out, ld_bout, alive_out, eps, n);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// vec: 1 for scalar loads, else 16-byte vectors (n a multiple of their
// width, the rows 16-byte aligned: the wrapper checks)
template <typename T>
int step(const T* w, T* vp, const T* v, const T* beta, int ld_beta,
         const int* alive, T* alpha_out, int ld_alpha, T* beta_out,
         int ld_bout, int* alive_out, const T* eps, int B, int n, int C,
         int vec, void* stream) {
    constexpr int kVec = 16 / (int)sizeof(T);
    if (B < 1 || B > 65535 || n < 1 || C < 1 || C > kMaxCluster ||
        (vec != 1 && (vec != kVec || n % kVec != 0)))
        return (int)cudaErrorInvalidValue;
    if (vec == 1)
        return launch<T, 1>(w, vp, v, beta, ld_beta, alive, alpha_out,
                            ld_alpha, beta_out, ld_bout, alive_out, eps, B, n,
                            C, stream);
    return launch<T, kVec>(w, vp, v, beta, ld_beta, alive, alpha_out,
                           ld_alpha, beta_out, ld_bout, alive_out, eps, B, n,
                           C, stream);
}

}  // namespace

#define LANCZOS_ENTRY(T, SFX)                                                 \
    extern "C" int lanczos_step_##SFX(                                        \
        const T* w, T* vp, const T* v, const T* beta, int ld_beta,            \
        const int* alive, T* alpha_out, int ld_alpha, T* beta_out,            \
        int ld_bout, int* alive_out, const T* eps, int B, int n, int C,       \
        int vec, void* stream) {                                              \
        return step<T>(w, vp, v, beta, ld_beta, alive, alpha_out, ld_alpha,   \
                       beta_out, ld_bout, alive_out, eps, B, n, C, vec,       \
                       stream);                                               \
    }

LANCZOS_ENTRY(float, f32)
LANCZOS_ENTRY(double, f64)
