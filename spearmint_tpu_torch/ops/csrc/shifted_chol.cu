// Blocked Cholesky, optionally of a diagonally shifted matrix, with the
// right-hand side solved during the factorization, for a batch of K lanes.
// Kernels B1, B2, B4a and B4b of the port.
//
// Replaces (TPU, Pallas): spearmint_tpu/ops/pallas_gp.py
//   shifted_logdet_q_pallas        (B1, :930 -> _call(shift=True), body
//                                   _make_kernel :279)
//   shifted_factor_logdet_q_pallas (B2, :777 -> _call(shift=True, emit=True))
//   logdet_q_pallas                (B4a, :896 -> _call(shift=False))
//   factor_logdet_q_pallas         (B4b, :743 -> _call(shift=False, emit=True))
// As in the Pallas source, the four are one kernel body: the diagonal
// tile adds the shift when dshift is not null.
//
// Computes, per lane, L = chol(M + diag(dshift)), or L = chol(M) with no
// shift, right-looking over panels of CHOL_PANEL columns, w = L^{-1} r
// alongside, and ld = sum log diag L, q = |w|^2.  The pivot is
// d = d2 * rsqrt(d2), so a non-positive pivot gives NaN (never +-inf) in
// that lane's ld and q only.  Padded observations (rows with M = 0 and
// shift 1, or identity rows of an unshifted M, with r = 0) factor to exact
// identity rows and add exactly 0 to ld and q.  ws leaves as L (lower; the
// diagonal tiles and, with emit, the strip above each panel are zeroed, so
// L is a complete lower-triangular matrix), w as L^{-1} r.
//
// What bounds it on an H100: the O(N^3/3) flops of the trailing updates,
// in f32 on the CUDA cores (TF32 tensor cores are excluded on purpose: the
// sampler and posterior need full f32), 67 TFLOP/s at the SXM part's
// 700 W.  Each panel step also reads and writes the lower trailing
// triangle once, so the schedule moves about N^3/(3 CHOL_PANEL) floats a
// lane: at 64-wide panels that alone took longer than the flops, at 256 a
// quarter of that.  Behind the trailing updates sits the serial chain of N
// pivots, paid CHOL_TILE at a time by one block per lane.
//
// Design: the host loop below runs, per CHOL_TILE-wide step, over a grid
// that includes the lane:
//   1. diag_kernel      factor the (shifted) 128x128 diagonal tile in
//                       dynamic shared memory as 4x4 blocks of 32x32, right-
//                       looking: one warp factors and inverts each diagonal
//                       block (no block barrier per column),
//                       one warp per block solves the blocks below and
//                       updates the rest (block barriers per block column);
//                       then L^{-1} by 2x2 block recursion, one warp per
//                       block; w_k <- L_kk^{-1} w_k, accumulate ld and q;
//   2. panel_kernel     L_ik = A_ik L_kk^{-T} and w_i -= L_ik w_k, one block
//                       per 128-row tile below;
//   3. trailing_kernel  A_ij -= L_ik L_jk^T over the lower 128x128 tiles,
//                       one block per tile (a triangular grid, decoded from
//                       blockIdx.x), depth CHOL_PANEL.  A panel wider than
//                       CHOL_TILE is factored CHOL_TILE columns at a time,
//                       each step first updating the panel's next columns.
// Steps 2 and 3 share one device routine of tile_ops.cuh (as do B3 and
// B5), tile_product: a 128x128 output
// tile, 256 threads, 8x8 outputs per thread in registers, operands staged
// through shared memory in 32-deep k-slices that cp.async double-buffers,
// so the next slice's copy overlaps this slice's FMAs.  Operands are stored
// k-major (s[m][r], row pitch 132: conflict-free transposing 4-byte copies,
// 16-byte aligned rows for float4 reads).  Two blocks fit on an SM.
// In the diagonal tile a warp's lane keeps one row of a 32x32 block in
// registers and reads the other operand as float4 broadcasts (row pitch
// 132: a lane's own float4 run hits distinct banks per quarter warp).
// A ragged edge (N not a multiple of 128) is masked inside the kernels: the
// last diagonal tile is padded with identity in shared memory and the
// copies zero-fill rows past N.  Kernels never allocate and never
// synchronise; the caller's stream orders the launches.  ld and q are
// accumulated by one block per lane in launch order, so they are
// deterministic, bit for bit.
#include "tile_ops.cuh"

#define CHOL_PANEL 256    // trailing depth; equal to gp_kernels.CHOL_PANEL

static_assert(CHOL_PANEL % CHOL_TILE == 0, "panel = whole tiles");

namespace {

__global__ void __launch_bounds__(NTHREADS, 1)
diag_kernel(float* __restrict__ ws, const float* __restrict__ dshift,
            float* __restrict__ w, float* __restrict__ linv,
            float* __restrict__ ld, float* __restrict__ q, int n, int s0)
{
    extern __shared__ float4 smem4[];
    const TileSmem sm = tile_smem(smem4);
    float* a = sm.a;     // the tile, then L
    float* x = sm.x;     // L^{-1}
    float* wk = sm.v;
    const int lane = blockIdx.x;
    const int tid = threadIdx.x;
    const int nb = min(CHOL_TILE, n - s0);
    const bool vec = (n & 3) == 0;   // then nb % 4 == 0 too
    float* A = ws + (size_t)lane * n * n;
    float* wl = w + (size_t)lane * n;

    // the tile (rows and columns past nb zero), x = 0; then the diagonal:
    // the shift, or identity past nb
    if (vec) {
#pragma unroll
        for (int it = 0; it < CHOL_TILE * CHOL_TILE / 4 / NTHREADS; ++it) {
            const int e = it * NTHREADS + tid;
            const int r = e >> 5, c = (e & 31) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < nb && c < nb)
                v = *reinterpret_cast<const float4*>(
                    A + (size_t)(s0 + r) * n + s0 + c);
            *reinterpret_cast<float4*>(a + r * SPAD + c) = v;
            *reinterpret_cast<float4*>(x + r * SPAD + c) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
#pragma unroll 4
        for (int e = tid; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
            const int r = e >> 7, c = e & (CHOL_TILE - 1);
            a[r * SPAD + c] = r < nb && c < nb
                ? A[(size_t)(s0 + r) * n + s0 + c] : 0.f;
            x[r * SPAD + c] = 0.f;
        }
    }
    if (tid < CHOL_TILE) wk[tid] = tid < nb ? wl[s0 + tid] : 0.f;
    __syncthreads();
    if (tid < CHOL_TILE) {
        float* d = a + tid * SPAD + tid;
        if (tid >= nb) *d = 1.f;
        else if (dshift) *d += dshift[(size_t)lane * n + s0 + tid];
    }
    __syncthreads();

    factor_tile(a, x, sm.col);
    invert_tile(a, x, sm.t);

    // w_k <- L_kk^{-1} w_k, then ld and q
    float lg = 0.f, sq = 0.f;
    tile_solve(a, x, wk, wl + s0, nb, lg, sq);
    lg = block_sum(lg, sm.red);
    if (tid == 0) ld[lane] += lg;
    sq = block_sum(sq, sm.red);
    if (tid == 0) q[lane] += sq;

    // linv <- X (row-major, for panel_kernel); the tile <- L, zeros above
    float* lv = linv + (size_t)lane * CHOL_TILE * CHOL_TILE;
#pragma unroll
    for (int it = 0; it < CHOL_TILE * CHOL_TILE / 4 / NTHREADS; ++it) {
        const int e = it * NTHREADS + tid;
        const int r = e >> 5, c = (e & 31) * 4;
        *reinterpret_cast<float4*>(lv + r * CHOL_TILE + c) =
            *reinterpret_cast<const float4*>(x + r * SPAD + c);
        const float4 u = *reinterpret_cast<const float4*>(a + r * SPAD + c);
        const float4 v = make_float4(c <= r ? u.x : 0.f,
                                     c + 1 <= r ? u.y : 0.f,
                                     c + 2 <= r ? u.z : 0.f,
                                     c + 3 <= r ? u.w : 0.f);
        float* out = A + (size_t)(s0 + r) * n + s0 + c;
        if (r >= nb) continue;
        if (vec) {
            if (c < nb) *reinterpret_cast<float4*>(out) = v;
        } else {
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u4 = 0; u4 < 4; ++u4)
                if (c + u4 < nb) out[u4] = vv[u4];
        }
    }
}

// ------------------------------------------------- panel and trailing tiles
__global__ void __launch_bounds__(NTHREADS, 2)
panel_kernel(float* __restrict__ ws, const float* __restrict__ linv,
             float* __restrict__ w, int n, int s0, int emit)
{
    extern __shared__ float4 smem4[];
    const int lane = blockIdx.y;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int r0 = s0 + CHOL_TILE + blockIdx.x * CHOL_TILE;
    const int rows = min(CHOL_TILE, n - r0);
    float* A = ws + (size_t)lane * n * n;
    float* wl = w + (size_t)lane * n;
    float acc[8][8];
    // L_ik = A_ik X^T, X = L_kk^{-1} row-major in linv
    tile_product(acc, reinterpret_cast<float*>(smem4),
                 A + (size_t)r0 * n + s0, n, rows,
                 linv + (size_t)lane * CHOL_TILE * CHOL_TILE, CHOL_TILE,
                 CHOL_TILE, CHOL_TILE);

    float wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[j] = wl[s0 + row_of(tx, j)];
    const bool vec = (n & 3) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row_of(ty, i);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) s += acc[i][j] * wv[j];
        // the 16 threads of a row are one half-warp: fixed-order sum
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        s += __shfl_xor_sync(kFull, s, 4);
        s += __shfl_xor_sync(kFull, s, 8);
        if (r >= rows) continue;
        if (tx == 0) wl[r0 + r] -= s;
        float* out = A + (size_t)(r0 + r) * n + s0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = 64 * h + tx * 4;
            if (vec) {
                *reinterpret_cast<float4*>(out + c) = make_float4(
                    acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                    acc[i][4 * h + 3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) out[c + j] = acc[i][4 * h + j];
            }
        }
    }
    if (emit) {   // the strip above: rows s0.., columns r0..
        for (int e = tid; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
            const int c = e >> 7, rt = e & (CHOL_TILE - 1);
            if (rt < rows) A[(size_t)(s0 + c) * n + r0 + rt] = 0.f;
        }
    }
}

// A_ij -= L_ik L_jk^T, k in [k0, k0 + depth), over the tiles at rows and
// columns t0 + 128 (bi, bj): the lower triangle of them, or with `narrow`
// only the column bj = 0 (the rest of a panel wider than CHOL_TILE).
__global__ void __launch_bounds__(NTHREADS, 2)
trailing_kernel(float* __restrict__ ws, int n, int k0, int depth, int t0,
                int narrow)
{
    extern __shared__ float4 smem4[];
    int bi = blockIdx.x, bj = 0;
    if (!narrow) tri_decode(blockIdx.x, bi, bj);
    const int lane = blockIdx.y;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int i0 = t0 + bi * CHOL_TILE, j0 = t0 + bj * CHOL_TILE;
    const int rows = min(CHOL_TILE, n - i0), cols = min(CHOL_TILE, n - j0);
    float* A = ws + (size_t)lane * n * n;
    float acc[8][8];
    tile_product(acc, reinterpret_cast<float*>(smem4),
                 A + (size_t)i0 * n + k0, n, rows,
                 A + (size_t)j0 * n + k0, n, cols, depth);

    const bool vec = (n & 3) == 0;   // then cols % 4 == 0 too
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row_of(ty, i);
        if (r >= rows) continue;
        float* out = A + (size_t)(i0 + r) * n + j0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = 64 * h + tx * 4;
            if (vec) {
                if (c < cols) {
                    float4 v = *reinterpret_cast<float4*>(out + c);
                    v.x -= acc[i][4 * h];
                    v.y -= acc[i][4 * h + 1];
                    v.z -= acc[i][4 * h + 2];
                    v.w -= acc[i][4 * h + 3];
                    *reinterpret_cast<float4*>(out + c) = v;
                }
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c + j < cols) out[c + j] -= acc[i][4 * h + j];
            }
        }
    }
}

}  // namespace

// K lanes of n x n.  m0, dshift, r: inputs (read only); dshift may be null
// (no shift: B4a, B4b).  ws [K,n,n] and w [K,n]: outputs L and L^{-1} r.
// linv [K,CHOL_TILE,CHOL_TILE]: scratch.  ld, q [K]: outputs.  emit != 0
// also zeroes the strip above each panel.
extern "C" int spm_shifted_chol(const void* m0, const void* dshift,
                                const void* r, void* ws, void* w, void* linv,
                                void* ld, void* q, int K, int n, int emit,
                                void* stream)
{
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t nn = (size_t)n * n;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(diag_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kTileSmem))) return err;
    if ((err = cudaFuncSetAttribute(panel_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kProdSmem))) return err;
    if ((err = cudaFuncSetAttribute(trailing_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kProdSmem))) return err;
    if ((err = cudaMemcpyAsync(ws, m0, K * nn * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemcpyAsync(w, r, (size_t)K * n * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemsetAsync(ld, 0, K * sizeof(float), s))) return err;
    if ((err = cudaMemsetAsync(q, 0, K * sizeof(float), s))) return err;
    float* W = static_cast<float*>(ws);
    float* V = static_cast<float*>(w);
    float* X = static_cast<float*>(linv);
    const float* D = static_cast<const float*>(dshift);
    float* LD = static_cast<float*>(ld);
    float* Q = static_cast<float*>(q);
    for (int k0 = 0; k0 < n; k0 += CHOL_PANEL) {
        const int k1 = min(k0 + CHOL_PANEL, n);
        for (int s0 = k0; s0 < k1; s0 += CHOL_TILE) {
            diag_kernel<<<K, NTHREADS, kTileSmem, s>>>(W, D, V, X, LD, Q, n,
                                                      s0);
            const int s1 = s0 + CHOL_TILE;
            if (s1 < n) {
                const int m = (n - s1 + CHOL_TILE - 1) / CHOL_TILE;
                panel_kernel<<<dim3(m, K), NTHREADS, kProdSmem, s>>>(
                    W, X, V, n, s0, emit);
                if (s1 < k1)   // the panel's next CHOL_TILE columns
                    trailing_kernel<<<dim3(m, K), NTHREADS, kProdSmem, s>>>(
                        W, n, s0, CHOL_TILE, s1, 1);
            }
            if ((err = cudaGetLastError())) return err;
        }
        if (k1 < n) {
            const int m = (n - k1 + CHOL_TILE - 1) / CHOL_TILE;
            trailing_kernel<<<dim3(m * (m + 1) / 2, K), NTHREADS, kProdSmem,
                              s>>>(W, n, k0, k1 - k0, k1, 0);
            if ((err = cudaGetLastError())) return err;
        }
    }
    return cudaGetLastError();
}
