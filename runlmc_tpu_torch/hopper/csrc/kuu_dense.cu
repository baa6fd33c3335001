// K1: the dense LMC grid kernel of one active-dim group,
//
//   K_UU[(d,i),(e,j)] = sum_q B[q,d,e] * tops[q, off(i,j)],
//   off(i,j) = sum_p |c_p(i) - c_p(j)| * stride_p,
//
// for a row-major grid of up to three dims with sizes (n0, n1, n2).
//
// Replaces the XLA code at runlmc_tpu/lmc/grid.py:537-547
// (build_group_state, dense branch), which gathers a (Q, m, m) block
// stack through a host-built (m, m) index map and contracts it with B.
// Here each thread works out its own BTTB offset from the two flat grid
// indices, so neither the index map nor the gathered stack exists.
//
// Bound on the card: the (Dm)^2 output write (76.6 MB in f64 at the
// fx2007 grid, Dm = 3094: about 23 us at 3.35 TB/s). tops (Q*m) and B
// (Q*D*D) are a few KB and stay in L1/L2. Design: consecutive threads on
// consecutive columns, so every row's write is coalesced; each thread
// walks a chunk of kRowsPerBlock rows of its column, so the column's
// grid coordinates are divided out once and the row's are stepped
// forward by increments, with no division per element.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 16;

template <typename T>
__global__ void kuu_dense_kernel(const T* __restrict__ tops,
                                 const T* __restrict__ B,
                                 T* __restrict__ out, int Q, int D, int m,
                                 int n0, int n1, int n2) {
    const int dm = D * m;
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    int row = blockIdx.y * kRowsPerBlock;
    const int row_end = min(row + kRowsPerBlock, dm);
    if (col >= dm || row >= row_end) return;
    const int stride1 = n2;
    const int stride0 = n1 * n2;
    const int e = col / m;
    const int j = col - e * m;
    const int j0 = j / stride0, j1 = (j / stride1) % n1, j2 = j % n2;
    int d = row / m;
    const int i = row - d * m;
    int i0 = i / stride0, i1 = (i / stride1) % n1, i2 = i % n2;
    for (; row < row_end; ++row) {
        const int off = abs(i0 - j0) * stride0 + abs(i1 - j1) * stride1 +
                        abs(i2 - j2);
        T acc = 0;
        for (int q = 0; q < Q; ++q) {
            acc += B[(q * D + d) * D + e] * tops[q * m + off];
        }
        out[(int64_t)row * dm + col] = acc;
        // step (d, i0, i1, i2) to the next row, row-major
        if (++i2 == n2) {
            i2 = 0;
            if (++i1 == n1) {
                i1 = 0;
                if (++i0 == n0) {
                    i0 = 0;
                    ++d;
                }
            }
        }
    }
}

template <typename T>
int launch(const T* tops, const T* B, T* out, int Q, int D, int m, int n0,
           int n1, int n2, void* stream) {
    const int dm = D * m;
    const int threads = 256;
    dim3 grid((unsigned)((dm + threads - 1) / threads),
              (unsigned)((dm + kRowsPerBlock - 1) / kRowsPerBlock));
    kuu_dense_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
        tops, B, out, Q, D, m, n0, n1, n2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kuu_dense_f32(const float* tops, const float* B, float* out,
                             int Q, int D, int m, int n0, int n1, int n2,
                             void* stream) {
    return launch<float>(tops, B, out, Q, D, m, n0, n1, n2, stream);
}

extern "C" int kuu_dense_f64(const double* tops, const double* B,
                             double* out, int Q, int D, int m, int n0,
                             int n1, int n2, void* stream) {
    return launch<double>(tops, B, out, Q, D, m, n0, n1, n2, stream);
}
