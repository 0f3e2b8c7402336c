// Shifted blocked Cholesky with the right-hand side solved during the
// factorization, for a batch of K lanes.  Kernels B1 and B2 of the port.
//
// Replaces (TPU, Pallas): spearmint_tpu/ops/pallas_gp.py
//   shifted_logdet_q_pallas        (B1, :930 -> _call(shift=True), body
//                                   _make_kernel :279)
//   shifted_factor_logdet_q_pallas (B2, :777 -> _call(shift=True, emit=True))
//
// Computes, per lane, L = chol(M + diag(dshift)) right-looking over panels
// of PANEL columns, w = L^{-1} r alongside, and ld = sum log diag L,
// q = |w|^2.  The pivot is d = d2 * rsqrt(d2), so a non-positive pivot
// gives NaN (never +-inf) in that lane's ld and q only.  Rows with M = 0
// and shift 1 (padded observations) factor to exact identity rows and add
// exactly 0 to ld and q.  ws leaves as L (lower; the diagonal tiles and,
// with emit, the strip above each panel are zeroed, so L is a complete
// lower-triangular matrix), w as L^{-1} r.
//
// What bounds it on an H100: the O(N^3/3) flops of the trailing updates,
// in f32 on the CUDA cores (TF32 tensor cores are excluded on purpose: the
// sampler and posterior need full f32), 67 TFLOP/s at the SXM part's
// 700 W; its N^2 bytes take under a twentieth of that time.  Behind the
// trailing updates sits the serial chain of N pivots, paid PANEL at a time
// by one block per lane.
//
// Design: the host loop below runs three launches per panel, each over a
// grid that includes the lane:
//   1. diag_kernel      factor the shifted diagonal tile in shared memory,
//                       invert it, w_k <- L_kk^{-1} w_k, accumulate ld, q;
//   2. panel_kernel     L_ik = A_ik L_kk^{-T} and w_i -= L_ik w_k for every
//                       row tile below, one block per 64-row tile;
//   3. trailing_kernel  A_ij -= L_ik L_jk^T over the lower tiles, one block
//                       per 64x64 tile, 4x4 outputs per thread in
//                       registers, operands from shared memory as float4.
// A ragged edge (N not a multiple of 64) is masked inside the kernels: the
// last diagonal tile is padded with identity in shared memory and the last
// row tile with zeros.  Kernels never allocate and never synchronise; the
// caller's stream orders the launches.  ld and q are accumulated by one
// block per lane in launch order, so they are deterministic.
#include "tile_ops.cuh"

namespace {

__global__ void __launch_bounds__(NTHREADS)
diag_kernel(float* __restrict__ ws, const float* __restrict__ dshift,
            float* __restrict__ w, float* __restrict__ linv,
            float* __restrict__ ld, float* __restrict__ q, int n, int k0)
{
    __shared__ float a[PANEL][PANEL + 1];
    __shared__ float x[PANEL][PANEL + 1];
    __shared__ float wk[PANEL];
    __shared__ float red[NTHREADS / 32];
    const int lane = blockIdx.x;
    const int tid = threadIdx.x;
    const int nb = min(PANEL, n - k0);
    float* A = ws + (size_t)lane * n * n;
    const float* ds = dshift + (size_t)lane * n;
    float* wl = w + (size_t)lane * n;

    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int r = e / PANEL, c = e % PANEL;
        float v = (r == c) ? 1.f : 0.f;
        if (r < nb && c <= r) {
            v = A[(size_t)(k0 + r) * n + k0 + c];
            if (r == c) v += ds[k0 + r];
        }
        a[r][c] = v;
    }
    if (tid < PANEL) wk[tid] = tid < nb ? wl[k0 + tid] : 0.f;
    __syncthreads();

    // unblocked right-looking Cholesky of the tile (lower triangle only)
    for (int j = 0; j < PANEL; ++j) {
        const float d2 = a[j][j];
        const float inv = rsqrtf(d2);
        __syncthreads();
        if (tid == j) a[j][j] = d2 * inv;
        else if (tid > j && tid < PANEL) a[tid][j] *= inv;
        __syncthreads();
        const int m = PANEL - 1 - j;
        for (int e = tid; e < m * m; e += NTHREADS) {
            const int r = j + 1 + e / m, c = j + 1 + e % m;
            if (c <= r) a[r][c] -= a[r][j] * a[c][j];
        }
        __syncthreads();
    }

    invert_lower_tile(a, x);
    __syncthreads();

    // w_k <- L_kk^{-1} w_k (four threads per row), then ld and q
    const int r = tid >> 2, part = tid & 3;
    float s = 0.f;
    for (int c = part; c <= r; c += 4) s += x[r][c] * wk[c];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    float lg = 0.f, sq = 0.f;
    if (part == 0 && r < nb) {
        wl[k0 + r] = s;
        sq = s * s;
        lg = logf(a[r][r]);
    }
    lg = block_sum(lg, red);
    if (tid == 0) ld[lane] += lg;
    sq = block_sum(sq, red);
    if (tid == 0) q[lane] += sq;

    float* lv = linv + (size_t)lane * PANEL * PANEL;
    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int rr = e / PANEL, c = e % PANEL;
        lv[e] = x[rr][c];
        if (rr < nb && c < nb)
            A[(size_t)(k0 + rr) * n + k0 + c] = c <= rr ? a[rr][c] : 0.f;
    }
}

__global__ void __launch_bounds__(NTHREADS)
panel_kernel(float* __restrict__ ws, const float* __restrict__ linv,
             float* __restrict__ w, int n, int k0, int emit)
{
    __shared__ float xs[PANEL][PANEL + 1];   // L_kk^{-1}
    __shared__ float as[PANEL][PANEL + 1];   // A_ik, then L_ik
    __shared__ float wk[PANEL];
    const int lane = blockIdx.y;
    const int tid = threadIdx.x;
    const int r0 = k0 + PANEL + blockIdx.x * PANEL;
    const int rows = min(PANEL, n - r0);
    float* A = ws + (size_t)lane * n * n;
    float* wl = w + (size_t)lane * n;
    const float* lv = linv + (size_t)lane * PANEL * PANEL;

    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int r = e / PANEL, c = e % PANEL;
        xs[r][c] = lv[e];
        as[r][c] = r < rows ? A[(size_t)(r0 + r) * n + k0 + c] : 0.f;
    }
    if (tid < PANEL) wk[tid] = wl[k0 + tid];
    __syncthreads();

    const int ty = tid >> 4, tx = tid & 15;
    float acc[4][4] = {};
    for (int m = 0; m < PANEL; ++m) {
        float av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[ty * 4 + i][m];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[tx * 4 + j][m];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * xv[j];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) as[ty * 4 + i][tx * 4 + j] = acc[i][j];
    __syncthreads();

    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int r = e / PANEL, c = e % PANEL;
        if (r < rows) A[(size_t)(r0 + r) * n + k0 + c] = as[r][c];
        if (emit) {
            const int rt = e % PANEL, ct = e / PANEL;   // transposed strip
            if (rt < rows) A[(size_t)(k0 + ct) * n + r0 + rt] = 0.f;
        }
    }

    const int r = tid >> 2, part = tid & 3;
    float s = 0.f;
    for (int c = part; c < PANEL; c += 4) s += as[r][c] * wk[c];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0 && r < rows) wl[r0 + r] -= s;
}

__global__ void __launch_bounds__(NTHREADS)
trailing_kernel(float* __restrict__ ws, int n, int k0)
{
    const int bi = blockIdx.y, bj = blockIdx.x;
    if (bj > bi) return;
    __shared__ __align__(16) float li[PANEL][TPAD];   // li[m][r] = L[i0+r][k0+m]
    __shared__ __align__(16) float lj[PANEL][TPAD];
    const int lane = blockIdx.z;
    const int tid = threadIdx.x;
    const int t0 = k0 + PANEL;
    const int i0 = t0 + bi * PANEL, j0 = t0 + bj * PANEL;
    float* A = ws + (size_t)lane * n * n;

    for (int e = tid; e < PANEL * PANEL; e += NTHREADS) {
        const int r = e / PANEL, m = e % PANEL;
        li[m][r] = i0 + r < n ? A[(size_t)(i0 + r) * n + k0 + m] : 0.f;
        lj[m][r] = j0 + r < n ? A[(size_t)(j0 + r) * n + k0 + m] : 0.f;
    }
    __syncthreads();

    const int ty = tid >> 4, tx = tid & 15;
    float acc[4][4] = {};
#pragma unroll 8
    for (int m = 0; m < PANEL; ++m) {
        const float4 av = *reinterpret_cast<const float4*>(&li[m][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&lj[m][tx * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a4[i] * b4[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = j0 + tx * 4 + j;
            if (c < n) A[(size_t)r * n + c] -= acc[i][j];
        }
    }
}

}  // namespace

// K lanes of n x n.  m0, dshift, r: inputs (read only).  ws [K,n,n] and
// w [K,n]: outputs L and L^{-1} r.  linv [K,PANEL,PANEL]: scratch.  ld, q
// [K]: outputs.  emit != 0 also zeroes the strip above each panel.
extern "C" int spm_shifted_chol(const void* m0, const void* dshift,
                                const void* r, void* ws, void* w, void* linv,
                                void* ld, void* q, int K, int n, int emit,
                                void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t nn = (size_t)n * n;
    cudaError_t err;
    if ((err = cudaMemcpyAsync(ws, m0, K * nn * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemcpyAsync(w, r, (size_t)K * n * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemsetAsync(ld, 0, K * sizeof(float), s))) return err;
    if ((err = cudaMemsetAsync(q, 0, K * sizeof(float), s))) return err;
    float* W = static_cast<float*>(ws);
    float* V = static_cast<float*>(w);
    float* X = static_cast<float*>(linv);
    for (int k0 = 0; k0 < n; k0 += PANEL) {
        diag_kernel<<<K, NTHREADS, 0, s>>>(
            W, static_cast<const float*>(dshift), V, X,
            static_cast<float*>(ld), static_cast<float*>(q), n, k0);
        const int rem = n - k0 - PANEL;
        if (rem > 0) {
            const int m = (rem + PANEL - 1) / PANEL;
            panel_kernel<<<dim3(m, K), NTHREADS, 0, s>>>(W, X, V, n, k0, emit);
            trailing_kernel<<<dim3(m, m, K), NTHREADS, 0, s>>>(W, n, k0);
        }
        if ((err = cudaGetLastError())) return err;
    }
    return cudaGetLastError();
}
