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
// (lanczos_core.cuh, shared with K12's minres.cu: C from the wrapper's
// lanczos_cluster, at most the portable 8), each CTA a contiguous slice
// of the row's 16-byte vectors. Pass 1 loads w, v_prev and v once and
// forms w1 and the partial <w1, v>; the cluster exchange (st.async into
// each CTA's mbarrier-counted shared memory, summed in (rank, warp)
// order by a fixed tree) gives every CTA the same alpha, and a relaunch
// the same bits (the cluster barrier that proves the cluster started is
// arrived at on entry and waited on after the loads). Pass 2
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

#include "common.cuh"
#include "lanczos_core.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace runlmc::rows;

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
    exchange_init<T, 2>(full, C);
    const int row = blockIdx.y;
    const Slice sl = row_slice(n / V, rank, C);
    const int lo = sl.lo, hi = sl.hi;
    const int64_t base = (int64_t)row * n;
    const P* wr = reinterpret_cast<const P*>(w + base);
    P* vpr = reinterpret_cast<P*>(vp + base);
    const P* vr = reinterpret_cast<const P*>(v + base);
    const T beta = beta_in[(int64_t)row * ld_beta];
    const bool live = alive_in[row] != 0;
    const T epsv = eps[0];
    const bool in_regs = held<V>(sl);

    // pass 1: w1 = w - beta v_prev, the partial <w1, v>
    P w1[kHeldVec], vh[kHeldVec];
    T acc = T(0);
    if (in_regs) {
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
    if (in_regs) {
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
    if (in_regs) {
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

// vec: 1 for scalar loads, else 16-byte vectors (n a multiple of their
// width, the rows 16-byte aligned: the wrapper checks)
template <typename T>
int step(const T* w, T* vp, const T* v, const T* beta, int ld_beta,
         const int* alive, T* alpha_out, int ld_alpha, T* beta_out,
         int ld_bout, int* alive_out, const T* eps, int B, int n, int C,
         int vec, void* stream) {
    constexpr int kVec = 16 / (int)sizeof(T);
    if (bad_shape<T>(B, n, C, vec)) return (int)cudaErrorInvalidValue;
    if (vec == 1)
        return launch_rows(lanczos_step_kernel<T, 1>, C, B, stream, w, vp, v,
                           beta, ld_beta, alive, alpha_out, ld_alpha,
                           beta_out, ld_bout, alive_out, eps, n);
    return launch_rows(lanczos_step_kernel<T, kVec>, C, B, stream, w, vp, v,
                       beta, ld_beta, alive, alpha_out, ld_alpha, beta_out,
                       ld_bout, alive_out, eps, n);
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
