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
// launch costs more than the bytes there.
//
// Gather: consecutive threads on consecutive rows, so the writes of a
// batch row coalesce. A thread loads its row's taps once, as 16-byte
// vectors (an int4 and a float4, or two double2, per 4 taps) where the
// tap count has an instance (4: 1-D cubic, 16: 2-D bicubic; TAPS = 0,
// the generic one, reads them per batch row), then walks a chunk of
// batch rows (1, 2 or 4, a function of (n, nbatch) alone:
// hopper/interp.py gather_chunk), so indices and weights are read once
// per chunk instead of once per batch row. The operand comes with its
// two strides (element b, c at v[b sb + c sc]), so a transposed view
// (kinv_diag's V = W F reads F^T) is read where it lies, with no copy
// first. Such an operand (sb == 1) goes to a column-tile variant
// (hopper/interp.py gather_layout): lanes on batch rows, so a warp's
// reads of a tap are consecutive addresses, the tile's sums through
// shared memory so that the writes coalesce too; a thread a row read
// 32 scattered addresses a warp there (63-103 us against 39-40 at
// kinv_diag's shape on the H100, chip_smoke.py --k10-k9-times).
// Each output sums t = 0 .. taps-1 in order as acc += v * w from 0, so
// every instance, chunk and layout gives the same bits.
//
// Scatter: one batch row per grid row; the random reads of x hit a few
// KB per batch row. It has two variants, which the host picks from
// (ncols, nnz, nbatch) alone (hopper/interp.py scatter_variant):
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

// 4 consecutive values from a 16-byte aligned address
__device__ __forceinline__ void load4(const int* p, int* o) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load4(const float* p, float* o) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* o) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

constexpr int kGatherThreads = 256;

// TAPS > 0: the row's taps in registers (TAPS a multiple of 4, idx and w
// 16-byte aligned); TAPS == 0: any tap count, read per batch row. Grid
// row y takes batch rows [y chunk, y chunk + chunk), then strides by
// gridDim.y chunk.
template <typename T, int TAPS>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const int* __restrict__ idx, const T* __restrict__ w,
              const T* __restrict__ v, T* __restrict__ out, int n, int taps,
              int nbatch, int64_t sb, int64_t sc, int chunk) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    constexpr int NT = TAPS > 0 ? TAPS : 1;
    // batch rows in flight a thread: 4 at 4 taps; 16 taps are enough
    // loads in flight alone (and more spill registers)
    constexpr int kUnroll = TAPS == 4 ? 4 : 1;
    int ix[NT];
    T wv[NT];
    if constexpr (TAPS > 0) {
#pragma unroll
        for (int t = 0; t < TAPS; t += 4) {
            load4(idx + (int64_t)r * TAPS + t, ix + t);
            load4(w + (int64_t)r * TAPS + t, wv + t);
        }
    }
    for (int64_t b0 = (int64_t)blockIdx.y * chunk; b0 < nbatch;
         b0 += (int64_t)gridDim.y * chunk) {
        const int64_t b1 = b0 + chunk < nbatch ? b0 + chunk : nbatch;
#pragma unroll kUnroll
        for (int64_t bt = b0; bt < b1; ++bt) {
            const T* vb = v + bt * sb;
            T acc = 0;
            if constexpr (TAPS > 0) {
#pragma unroll
                for (int t = 0; t < TAPS; ++t) {
                    acc += vb[ix[t] * sc] * wv[t];
                }
            } else {
                for (int t = 0; t < taps; ++t) {
                    acc += vb[idx[(int64_t)r * taps + t] * sc] *
                           w[(int64_t)r * taps + t];
                }
            }
            out[bt * n + r] = acc;
        }
    }
}

// The column-tile variant, for an operand whose batch rows are adjacent
// in memory (sb == 1: a transposed view such as kinv_diag's F^T). A CTA
// takes a tile of kTile rows x kTile CW batch rows: lane l of each warp
// takes batch rows b0 + l and b0 + l + 32 (CW = 2: hopper/interp.py
// GATHER_CHUNKS; 1 was slower at kinv_diag's shape), so each tap's
// reads of the warp are runs of consecutive addresses, and warp w takes
// rows r0 + w, r0 + w + 8, ... (the row's taps the same across the
// warp, read once for its CW batch rows). The sums go through shared
// memory and leave with lanes on rows, so the writes coalesce as well.
// Grid column x takes row tile x, grid row y batch tiles y, y +
// gridDim.y, ...
constexpr int kTile = 32;
constexpr int CW = 2;

template <typename T, int TAPS>
__global__ void __launch_bounds__(kGatherThreads)
gather_cols_kernel(const int* __restrict__ idx, const T* __restrict__ w,
                   const T* __restrict__ v, T* __restrict__ out, int n,
                   int taps, int nbatch, int64_t sc) {
    __shared__ T tile[kTile * CW][kTile + 1];  // [batch row][row]
    constexpr int kWarps = kGatherThreads / 32;
    constexpr int NT = TAPS > 0 ? TAPS : 1;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int r0 = blockIdx.x * kTile;
    for (int64_t b0 = (int64_t)blockIdx.y * kTile * CW; b0 < nbatch;
         b0 += (int64_t)gridDim.y * kTile * CW) {
#pragma unroll
        for (int k = 0; k < kTile / kWarps; ++k) {
            const int i = warp + k * kWarps;
            const int r = r0 + i;
            T acc[CW];
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[c] = 0;
            if (r < n) {
                int ix[NT];
                T wv[NT];
                if constexpr (TAPS > 0) {
#pragma unroll
                    for (int t = 0; t < TAPS; t += 4) {
                        load4(idx + (int64_t)r * TAPS + t, ix + t);
                        load4(w + (int64_t)r * TAPS + t, wv + t);
                    }
                }
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                    const int64_t b = b0 + lane + 32 * c;
                    if (b >= nbatch) break;
                    const T* vb = v + b;
                    if constexpr (TAPS > 0) {
#pragma unroll
                        for (int t = 0; t < TAPS; ++t) {
                            acc[c] += vb[ix[t] * sc] * wv[t];
                        }
                    } else {
                        for (int t = 0; t < taps; ++t) {
                            acc[c] += vb[idx[(int64_t)r * taps + t] * sc] *
                                      w[(int64_t)r * taps + t];
                        }
                    }
                }
            }
#pragma unroll
            for (int c = 0; c < CW; ++c) tile[lane + 32 * c][i] = acc[c];
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kTile * CW / kWarps; ++k) {
            const int j = warp + k * kWarps;
            const int64_t bj = b0 + j;
            const int r = r0 + lane;
            if (bj < nbatch && r < n) out[bj * n + r] = tile[j][lane];
        }
        __syncthreads();
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

// gather layouts (hopper/interp.py GATHER_ROWS, GATHER_COLS)
constexpr int kGatherRows = 0;
constexpr int kGatherCols = 1;

template <typename T>
static int gather_cols(const int* idx, const T* w, const T* v, T* out,
                       int n, int taps, int nbatch, int64_t sc,
                       int taps_instance, cudaStream_t st) {
    dim3 grid((unsigned)((n + kTile - 1) / kTile),
              runlmc::grid_y(((int64_t)nbatch + kTile * CW - 1) /
                             (kTile * CW)));
    if (taps_instance == 4 && taps == 4) {
        gather_cols_kernel<T, 4><<<grid, kGatherThreads, 0, st>>>(
            idx, w, v, out, n, taps, nbatch, sc);
    } else if (taps_instance == 16 && taps == 16) {
        gather_cols_kernel<T, 16><<<grid, kGatherThreads, 0, st>>>(
            idx, w, v, out, n, taps, nbatch, sc);
    } else if (taps_instance == 0) {
        gather_cols_kernel<T, 0><<<grid, kGatherThreads, 0, st>>>(
            idx, w, v, out, n, taps, nbatch, sc);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename T>
static int gather(const int* idx, const T* w, const T* v, T* out, int n,
                  int taps, int nbatch, int64_t sb, int64_t sc,
                  int taps_instance, int chunk, int layout, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (layout == kGatherCols) {
        // chunk: batch rows a lane, 32 apart
        if (sb != 1 || chunk != CW) return (int)cudaErrorInvalidValue;
        return gather_cols<T>(idx, w, v, out, n, taps, nbatch, sc,
                              taps_instance, st);
    }
    if (layout != kGatherRows || chunk < 1) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((n + kGatherThreads - 1) / kGatherThreads),
              runlmc::grid_y(((int64_t)nbatch + chunk - 1) / chunk));
    if (taps_instance == 4 && taps == 4) {
        gather_kernel<T, 4><<<grid, kGatherThreads, 0, st>>>(
            idx, w, v, out, n, taps, nbatch, sb, sc, chunk);
    } else if (taps_instance == 16 && taps == 16) {
        gather_kernel<T, 16><<<grid, kGatherThreads, 0, st>>>(
            idx, w, v, out, n, taps, nbatch, sb, sc, chunk);
    } else if (taps_instance == 0) {
        gather_kernel<T, 0><<<grid, kGatherThreads, 0, st>>>(
            idx, w, v, out, n, taps, nbatch, sb, sc, chunk);
    } else {
        return (int)cudaErrorInvalidValue;
    }
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
                                 int nbatch, int64_t sb, int64_t sc,
                                 int taps_instance, int chunk, int layout,
                                 void* stream) {
    return gather<float>(idx, w, v, out, n, taps, nbatch, sb, sc,
                         taps_instance, chunk, layout, stream);
}

extern "C" int interp_gather_f64(const int* idx, const double* w,
                                 const double* v, double* out, int n,
                                 int taps, int nbatch, int64_t sb,
                                 int64_t sc, int taps_instance, int chunk,
                                 int layout, void* stream) {
    return gather<double>(idx, w, v, out, n, taps, nbatch, sb, sc,
                          taps_instance, chunk, layout, stream);
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
