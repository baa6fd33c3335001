// K9: the SKI interpolation operator W (n x ncols, `taps` nonzeros per
// row) applied to a batch, both ways:
//
//   gather   out[b, r] = sum_t w[r, t] * v[b, idx[r, t]]         (W v)
//   scatter  out[b, c] = sum_{e in col c} wt[e] * x[b, rows[e]]  (W^T x)
//
// Replaces the XLA code at runlmc_tpu/ops/interpolation.py:219-240
// (Interp.matvec, a take + einsum; Interp.rmatvec, a scatter-add), and
// K4's W-block applies (runlmc_tpu/lmc/woodbury.py:141, _wt / _w).
// The scatter reads a transposed CSR of W built once on the host
// (ptr, rows, wt): each output column is a private sum, so there are no
// atomics and the result is the same on every run, duplicate
// (clamped-edge) indices included.
//
// Bound on the card: bytes. The predictive mean runs both on one f64
// vector: the scatter W^T alpha (n = 3113 -> ncols = 3094, 12452 CSR
// entries, about 211 KB: 0.06 us at 3.35 TB/s) and the gather of the
// 150 test rows (4 taps on a 3094-vector, about 33 KB: 0.01 us), so a
// launch costs more than the bytes there. Design: consecutive threads
// on consecutive rows (gather), one batch row per grid row, so the
// writes coalesce; the random reads of v and x hit a few KB per batch
// row. The scatter has two variants, which the host picks from (ncols,
// nnz, nbatch) alone (hopper/interp.py scatter_variant):
//   thread  a thread per column walks its entries in order: short
//           columns (4-6 entries a column at the 1-D sites) over many
//           batch rows, where the columns alone fill the card;
//   warp    a warp per column: lane l takes entries l, l + 32, ... in
//           order, then a fixed xor-shuffle tree adds the 32 lane sums.
//           Synth's one-column apply (47,480 rows x 16 taps over 4205
//           columns, about 180 entries a column) ran as 17 CTAs of
//           serial sums in the thread variant (31 us against 1.9 us of
//           bytes); as warps it fills the card and each lane sums about
//           6 terms.
// Both sum in an order fixed by the CSR, so relaunches are bit-identical.

#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_kernel(const int* __restrict__ idx,
                              const T* __restrict__ w,
                              const T* __restrict__ v, T* __restrict__ out,
                              int n, int taps, int ncols, int nbatch) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    for (int64_t bt = blockIdx.y; bt < nbatch; bt += gridDim.y) {
        const T* vb = v + bt * ncols;
        T acc = 0;
        for (int t = 0; t < taps; ++t) {
            acc += vb[idx[(int64_t)r * taps + t]] * w[(int64_t)r * taps + t];
        }
        out[bt * n + r] = acc;
    }
}

template <typename T>
__global__ void scatter_kernel(const int* __restrict__ ptr,
                               const int* __restrict__ rows,
                               const T* __restrict__ wt,
                               const T* __restrict__ x, T* __restrict__ out,
                               int n, int ncols, int nbatch) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncols) return;
    const int lo = ptr[c], hi = ptr[c + 1];
    for (int64_t bt = blockIdx.y; bt < nbatch; bt += gridDim.y) {
        const T* xb = x + bt * n;
        T acc = 0;
        for (int e = lo; e < hi; ++e) acc += xb[rows[e]] * wt[e];
        out[bt * ncols + c] = acc;
    }
}

template <typename T>
__global__ void scatter_warp_kernel(const int* __restrict__ ptr,
                                    const int* __restrict__ rows,
                                    const T* __restrict__ wt,
                                    const T* __restrict__ x,
                                    T* __restrict__ out, int n, int ncols,
                                    int nbatch) {
    const int c = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) /
                        32);
    const int lane = threadIdx.x % 32;
    if (c >= ncols) return;  // the whole warp: c is the warp's
    const int lo = ptr[c], hi = ptr[c + 1];
    for (int64_t bt = blockIdx.y; bt < nbatch; bt += gridDim.y) {
        const T* xb = x + bt * n;
        T acc = 0;
        for (int e = lo + lane; e < hi; e += 32) acc += xb[rows[e]] * wt[e];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) out[bt * ncols + c] = acc;
    }
}

}  // namespace

// scatter variants (hopper/interp.py SCATTER_THREAD, SCATTER_WARP)
constexpr int kScatterThread = 0;
constexpr int kScatterWarp = 1;

template <typename T>
static int gather(const int* idx, const T* w, const T* v, T* out, int n,
                  int taps, int ncols, int nbatch, void* stream) {
    const int threads = 256;
    dim3 grid((unsigned)((n + threads - 1) / threads), runlmc::grid_y(nbatch));
    gather_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
        idx, w, v, out, n, taps, ncols, nbatch);
    return (int)cudaGetLastError();
}

template <typename T>
static int scatter(const int* ptr, const int* rows, const T* wt, const T* x,
                   T* out, int n, int ncols, int nbatch, int variant,
                   void* stream) {
    const int threads = 256;
    if (variant == kScatterWarp) {
        dim3 grid((unsigned)(((int64_t)ncols * 32 + threads - 1) / threads),
                  runlmc::grid_y(nbatch));
        scatter_warp_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
            ptr, rows, wt, x, out, n, ncols, nbatch);
    } else if (variant == kScatterThread) {
        dim3 grid((unsigned)((ncols + threads - 1) / threads),
                  runlmc::grid_y(nbatch));
        scatter_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
            ptr, rows, wt, x, out, n, ncols, nbatch);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int interp_gather_f32(const int* idx, const float* w,
                                 const float* v, float* out, int n, int taps,
                                 int ncols, int nbatch, void* stream) {
    return gather<float>(idx, w, v, out, n, taps, ncols, nbatch, stream);
}

extern "C" int interp_gather_f64(const int* idx, const double* w,
                                 const double* v, double* out, int n,
                                 int taps, int ncols, int nbatch,
                                 void* stream) {
    return gather<double>(idx, w, v, out, n, taps, ncols, nbatch, stream);
}

extern "C" int interp_scatter_f32(const int* ptr, const int* rows,
                                  const float* wt, const float* x,
                                  float* out, int n, int ncols, int nbatch,
                                  int variant, void* stream) {
    return scatter<float>(ptr, rows, wt, x, out, n, ncols, nbatch, variant,
                          stream);
}

extern "C" int interp_scatter_f64(const int* ptr, const int* rows,
                                  const double* wt, const double* x,
                                  double* out, int n, int ncols, int nbatch,
                                  int variant, void* stream) {
    return scatter<double>(ptr, rows, wt, x, out, n, ncols, nbatch, variant,
                           stream);
}
