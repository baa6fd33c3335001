// K1 (+K8): the dense LMC grid kernel of one active-dim group, with the
// kernels' k(r) on the grid evaluated inside the launch,
//
//   K_UU[(d,i),(e,j)] = sum_q B[q,d,e] * scale_q * k~_q(dists[off(i,j)]),
//   off(i,j) = sum_p |c_p(i) - c_p(j)| * stride_p,
//
// for a row-major grid of up to three dims with sizes (n0, n1, n2), where
// dists (m,) are the grid's first-row distances and (kind_q, gamma_q,
// period_q, scale_q) the group's rows of the kernel table
// (LMCKernelSpec.table_rows; k~ as common.cuh kern_eval).
//
// Replaces the XLA code at runlmc_tpu/lmc/grid.py:535-547
// (build_group_state, dense branch): the elementwise k(r) of
// runlmc_tpu/kernels/stationary.py:64-157 on the (m,) first rows (K8),
// stacked into tops (Q, m), then a gather of a (Q, m, m) block stack
// through a host-built (m, m) index map and its contraction with B.
// Here neither tops in device memory, the index map nor the stack
// exists.
//
// Bound on the card: the (Dm)^2 output write (76.6 MB in f64 at the
// fx2007 grid, Dm = 3094: about 23 us at 3.35 TB/s). K8's own work is
// Q*m transcendentals.
//
// Design: each CTA first evaluates scale_q * k~_q at every offset of
// the grid into shared memory (nq*m values: 60 KB in f32 at the weather
// twin, Q = 6, m = 2504; more than 48 KB is opted in), so the output
// loop does one shared-memory read and one FMA per q and element. Each
// CTA walks tiles of kRowsPerBlock rows by kThreads columns. Where the
// prologue is a few values per thread (fx2007: m = 238) every tile gets
// a CTA of its own; where it is many (the weather twin: 59 per thread),
// the CTAs walk about as many tiles each as they evaluated values per
// thread, and no fewer CTAs than fit on the card at once, so the
// prologue is paid a few hundred times, not once per tile (Q
// transcendentals per output element would be 6e8 at the weather twin).
// Consecutive threads take consecutive columns, so every row's write is
// coalesced. Each thread keeps its column's kRowsPerBlock offsets and
// sums in registers (the row's grid coordinates stepped by increments,
// no division per element) and adds q by q across all of them, so the
// rows' shared-memory reads and FMAs are independent of each other; B
// is read once per q where the tile stays in one output block. When
// the table of a group does not fit in the shared-memory budget, the
// q's run as several launches, the later ones adding into the output in
// a fixed order.

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 512;
// shared memory per CTA beyond which q's go to separate launches (two
// CTAs of this size fit on one SM)
constexpr size_t kTableBudget = 112 * 1024;
// prologue values per thread up to which every tile gets its own CTA
constexpr int64_t kCheapPrologue = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
kuu_dense_kernel(runlmc::KindTable kinds, const T* __restrict__ prm,
                 const T* __restrict__ dists, const T* __restrict__ B,
                 T* __restrict__ out, int D, int m, int n0, int n1, int n2,
                 int q0, int nq, int accumulate) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tops = reinterpret_cast<T*>(smem_raw);  // (nq, m)
    for (int t = threadIdx.x; t < nq * m; t += kThreads) {
        const int qq = t / m;
        const int o = t - qq * m;
        const T* p = prm + (q0 + qq) * 3;
        tops[t] = p[2] * runlmc::kern_eval<T>(kinds.kind[q0 + qq], dists[o],
                                              p[0], p[1]);
    }
    __syncthreads();
    const int dm = D * m;
    const int col_blocks = (dm + kThreads - 1) / kThreads;
    const int64_t tiles =
        (int64_t)col_blocks * ((dm + kRowsPerBlock - 1) / kRowsPerBlock);
    const int stride1 = n2;
    const int stride0 = n1 * n2;
    const int dd = D * D;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int rb = (int)(tile / col_blocks);
        const int col =
            (int)(tile - (int64_t)rb * col_blocks) * kThreads + threadIdx.x;
        if (col >= dm) continue;
        const int row0 = rb * kRowsPerBlock;
        const int e = col / m;
        const int j = col - e * m;
        const int j0 = j / stride0, j1 = (j / stride1) % n1, j2 = j % n2;
        const int d0 = row0 / m;
        const int i = row0 - d0 * m;
        int i0 = i / stride0, i1 = (i / stride1) % n1, i2 = i % n2;
        // the tile's rows: their offsets, stepping (i0, i1, i2) row-major;
        // rows past the grid wrap round and are not written
        int off[kRowsPerBlock];
#pragma unroll
        for (int r = 0; r < kRowsPerBlock; ++r) {
            off[r] = abs(i0 - j0) * stride0 + abs(i1 - j1) * stride1 +
                     abs(i2 - j2);
            if (++i2 == n2) {
                i2 = 0;
                if (++i1 == n1) {
                    i1 = 0;
                    if (++i0 == n0) i0 = 0;
                }
            }
        }
        // one output block d for all rows of the tile (the rule unless the
        // tile crosses a block boundary)
        const int d_last = min((row0 + kRowsPerBlock - 1) / m, D - 1);
        const bool one_block = d_last == d0;
        T acc[kRowsPerBlock];
#pragma unroll
        for (int r = 0; r < kRowsPerBlock; ++r) acc[r] = T(0);
        for (int qq = 0; qq < nq; ++qq) {
            const T* tq = tops + qq * m;
            const T* Bq = B + (int64_t)(q0 + qq) * dd + e;
            if (one_block) {
                const T b = Bq[d0 * D];
#pragma unroll
                for (int r = 0; r < kRowsPerBlock; ++r) {
                    acc[r] += b * tq[off[r]];
                }
            } else {
#pragma unroll
                for (int r = 0; r < kRowsPerBlock; ++r) {
                    const int d = min((row0 + r) / m, D - 1);
                    acc[r] += Bq[d * D] * tq[off[r]];
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerBlock; ++r) {
            if (row0 + r < dm) {
                T* dst = out + (int64_t)(row0 + r) * dm + col;
                *dst = accumulate ? *dst + acc[r] : acc[r];
            }
        }
    }
}

// What a launch asks of the host, found on a device's first launch and
// kept: the opt-in shared-memory limit, the SM count, and the CTAs per
// SM at each shared-memory size seen (a group's m fixes its sizes, so a
// run sees a few). The kernel's dynamic shared-memory limit is raised
// once, to the opt-in limit, so no launch sets a function attribute.
constexpr int kMaxDevices = 64;
constexpr int kSizesKept = 16;

struct LaunchFacts {
    bool ready = false;
    int optin = 0;
    int sms = 0;
    int kept = 0;
    size_t smem[kSizesKept];
    int per_sm[kSizesKept];
};

template <typename T>
int launch_facts(size_t smem, int* optin, int* sms, int* per_sm) {
    static LaunchFacts facts[kMaxDevices];
    static std::mutex lock;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(lock);
    LaunchFacts& f = facts[dev];
    if (!f.ready) {
        err = cudaDeviceGetAttribute(
            &f.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(
                &f.sms, cudaDevAttrMultiProcessorCount, dev);
        }
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                kuu_dense_kernel<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, f.optin);
        }
        if (err != cudaSuccess) return (int)err;
        f.ready = true;
    }
    *optin = f.optin;
    *sms = f.sms;
    if (smem > (size_t)f.optin) return 0;
    for (int i = 0; i < f.kept; ++i) {
        if (f.smem[i] == smem) {
            *per_sm = f.per_sm[i];
            return 0;
        }
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kuu_dense_kernel<T>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (f.kept < kSizesKept) {
        f.smem[f.kept] = smem;
        f.per_sm[f.kept] = *per_sm;
        ++f.kept;
    }
    return 0;
}

template <typename T>
int launch(const int* kinds_host, const T* prm, const T* dists, const T* B,
           T* out, int Q, int D, int m, int n0, int n1, int n2,
           void* stream) {
    if (Q < 1 || Q > runlmc::kMaxTableQ || m < 1) {
        return (int)cudaErrorInvalidValue;
    }
    runlmc::KindTable kinds;
    for (int q = 0; q < Q; ++q) kinds.kind[q] = kinds_host[q];
    const size_t row_bytes = (size_t)m * sizeof(T);
    const size_t budget =
        row_bytes > kTableBudget ? row_bytes : kTableBudget;
    const int per_launch = (int)(budget / row_bytes) < Q
                               ? (int)(budget / row_bytes)
                               : Q;
    const int dm = D * m;
    const int64_t tiles = (int64_t)((dm + kThreads - 1) / kThreads) *
                          ((dm + kRowsPerBlock - 1) / kRowsPerBlock);
    for (int q0 = 0; q0 < Q; q0 += per_launch) {
        const int nq = Q - q0 < per_launch ? Q - q0 : per_launch;
        const size_t smem = (size_t)nq * row_bytes;
        int optin = 0, sms = 0, per_sm = 0;
        int err = launch_facts<T>(smem, &optin, &sms, &per_sm);
        if (err != 0) return err;
        if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        // prologue values per thread; as many tiles per CTA
        const int64_t per_thread =
            ((int64_t)nq * m + kThreads - 1) / kThreads;
        int64_t ctas = per_thread <= kCheapPrologue
                           ? tiles
                           : (tiles + per_thread - 1) / per_thread;
        const int64_t resident = (int64_t)per_sm * sms;
        if (ctas < resident) ctas = resident;
        const unsigned grid = (unsigned)(tiles < ctas ? tiles : ctas);
        kuu_dense_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
            kinds, prm, dists, B, out, D, m, n0, n1, n2, q0, nq, q0 > 0);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return 0;
}

}  // namespace

extern "C" int kuu_dense_f32(const int* kinds, const float* prm,
                             const float* dists, const float* B, float* out,
                             int Q, int D, int m, int n0, int n1, int n2,
                             void* stream) {
    return launch<float>(kinds, prm, dists, B, out, Q, D, m, n0, n1, n2,
                         stream);
}

extern "C" int kuu_dense_f64(const int* kinds, const double* prm,
                             const double* dists, const double* B,
                             double* out, int Q, int D, int m, int n0,
                             int n1, int n2, void* stream) {
    return launch<double>(kinds, prm, dists, B, out, Q, D, m, n0, n1, n2,
                          stream);
}
