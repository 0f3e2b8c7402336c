// Blocked inverse of lower-triangular factors, X = L^{-1}, for a batch of
// K lanes.  Kernel B3 of the port.
//
// Replaces (TPU, Pallas): spearmint_tpu/ops/pallas_gp.py tri_inverse_pallas
// (:816 -> _tri_inverse_call :703, body _make_inv_kernel :616).
//
// Block forward substitution over PANEL-wide tiles:
//   X_ii = L_ii^{-1},   X_ij = -X_ii * sum_{j<=k<i} L_ik X_kj   (j < i),
// with exact zeros above the diagonal.  Only the lower triangle of each
// diagonal tile and the tiles left of it are read, so the input may hold
// anything above the block diagonal.
//
// What bounds it on an H100: N^3/3 flops per lane in f32 on the CUDA cores
// (67 TFLOP/s at the SXM part's 700 W); the 2 N^2 floats it reads and
// writes take a small fraction of that.  The dependency chain runs over
// the block rows: row i needs every X_kj with k < i.
//
// Design: one launch inverts every diagonal tile of every lane and zeroes
// the tiles right of it; then one launch per block row i computes all
// X_ij, j < i, one 64x64 output tile per block, accumulating the k-sum in
// registers (4x4 outputs per thread, operands from shared memory as
// float4) and finishing with the product by X_ii.  The ragged last row
// tile is masked.  Kernels never allocate and never synchronise.
#include "tile_ops.cuh"

namespace {

__global__ void __launch_bounds__(NTHREADS)
tri_diag_kernel(const float* __restrict__ L, float* __restrict__ X, int n)
{
    __shared__ float a[PANEL][PANEL + 1];
    __shared__ float x[PANEL][PANEL + 1];
    const int i = blockIdx.x, lane = blockIdx.y;
    const int tid = threadIdx.x;
    const int r0 = i * PANEL;
    const int nb = min(PANEL, n - r0);
    const float* Ll = L + (size_t)lane * n * n;
    float* Xl = X + (size_t)lane * n * n;

    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int r = e / PANEL, c = e % PANEL;
        float v = (r == c) ? 1.f : 0.f;
        if (r < nb && c <= r) v = Ll[(size_t)(r0 + r) * n + r0 + c];
        a[r][c] = v;
    }
    __syncthreads();
    invert_lower_tile(a, x);
    __syncthreads();

    const int width = n - r0;   // diagonal tile and everything right of it
    for (int r = 0; r < nb; ++r)
        for (int c = tid; c < width; c += NTHREADS)
            Xl[(size_t)(r0 + r) * n + r0 + c] = c < nb ? x[r][c] : 0.f;
}

__global__ void __launch_bounds__(NTHREADS)
tri_row_kernel(const float* __restrict__ L, float* __restrict__ X, int n,
               int i)
{
    __shared__ __align__(16) float lt[PANEL][TPAD];   // lt[m][r] = L_ik[r][m]
    __shared__ __align__(16) float xk[PANEL][TPAD];   // xk[m][c] = X_kj[m][c]
    const int j = blockIdx.x, lane = blockIdx.y;
    const int tid = threadIdx.x;
    const int r0 = i * PANEL, c0 = j * PANEL;
    const int rows = min(PANEL, n - r0);
    const float* Ll = L + (size_t)lane * n * n;
    float* Xl = X + (size_t)lane * n * n;
    const int ty = tid >> 4, tx = tid & 15;

    float acc[4][4] = {};
    for (int k = j; k < i; ++k) {
        const int k0 = k * PANEL;
        for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
            const int r = e / PANEL, m = e % PANEL;
            lt[m][r] = r < rows ? Ll[(size_t)(r0 + r) * n + k0 + m] : 0.f;
            xk[r][m] = Xl[(size_t)(k0 + r) * n + c0 + m];
        }
        __syncthreads();
#pragma unroll 8
        for (int m = 0; m < PANEL; ++m) {
            const float4 av = *reinterpret_cast<const float4*>(&lt[m][ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&xk[m][tx * 4]);
            const float a4[4] = {av.x, av.y, av.z, av.w};
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int t = 0; t < 4; ++t) acc[p][t] += a4[p] * b4[t];
        }
        __syncthreads();
    }

    // X_ij = -X_ii * acc: acc goes to xk (row-major), X_ii^T to lt
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int t = 0; t < 4; ++t) xk[ty * 4 + p][tx * 4 + t] = acc[p][t];
    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int r = e / PANEL, m = e % PANEL;
        lt[m][r] = (r < rows && m < rows)
                       ? Xl[(size_t)(r0 + r) * n + r0 + m] : 0.f;
    }
    __syncthreads();
    float out[4][4] = {};
#pragma unroll 8
    for (int m = 0; m < PANEL; ++m) {
        const float4 av = *reinterpret_cast<const float4*>(&lt[m][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&xk[m][tx * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int t = 0; t < 4; ++t) out[p][t] -= a4[p] * b4[t];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int r = ty * 4 + p;
        if (r >= rows) continue;
#pragma unroll
        for (int t = 0; t < 4; ++t)
            Xl[(size_t)(r0 + r) * n + c0 + tx * 4 + t] = out[p][t];
    }
}

}  // namespace

// K lanes of n x n.  l: input factor (lower triangle read), x: output.
extern "C" int spm_tri_inverse(const void* l, void* x, int K, int n,
                               void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* Lp = static_cast<const float*>(l);
    float* Xp = static_cast<float*>(x);
    const int nb = (n + PANEL - 1) / PANEL;
    tri_diag_kernel<<<dim3(nb, K), NTHREADS, 0, s>>>(Lp, Xp, n);
    cudaError_t err = cudaGetLastError();
    if (err) return err;
    for (int i = 1; i < nb; ++i) {
        tri_row_kernel<<<dim3(i, K), NTHREADS, 0, s>>>(Lp, Xp, n, i);
        if ((err = cudaGetLastError())) return err;
    }
    return cudaSuccess;
}
