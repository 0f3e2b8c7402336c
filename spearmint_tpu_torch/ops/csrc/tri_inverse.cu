// Inverse of lower-triangular factors, X = L^{-1}, for a batch of K lanes.
// Kernel B3 of the port.
//
// Replaces (TPU, Pallas): spearmint_tpu/ops/pallas_gp.py tri_inverse_pallas
// (:816 -> _tri_inverse_call :703, pallas_call :711, body
// _make_inv_kernel :616), which substitutes block row by block row.
//
// Computes X = L^{-1} with exact zeros above the diagonal.  Only the lower
// triangle of each 128-wide diagonal tile and the tiles left of it are
// read, so the input may hold anything above the block diagonal.  A
// ragged n (not a multiple of 128) is masked inside the kernels; padded
// identity rows of L give identity rows of X.
//
// What bounds it on an H100: n^3/3 flops per lane in f32 on the CUDA cores
// (67 TFLOP/s at the SXM part's 700 W; TF32 is excluded by design); the
// 2 n^2 floats it reads and writes take a small fraction of that.  Row by
// row substitution (one launch per block row) also serialises the work:
// the longest chain is a whole row's depth on one block at a time.
//
// Design: 2x2 block recursion over 128-wide tiles, the same recursion
// that invert_tile runs inside a tile, so the dependency chain is
// log2(n / 128) levels long instead of n / 128 rows:
//   1. leaf_kernel   one block per (diagonal tile, lane): the tile's lower
//                    triangle in dynamic shared memory, its four 32x32
//                    diagonal blocks inverted by one warp each, then
//                    invert_tile; writes X_ii with zeros above its diagonal;
//   2. per level w = 1, 2, 4, ... tiles, over the pairs A = [lo, lo + w),
//      B = [lo + w, min(lo + 2w, nb)) (a ragged last pair included):
//      tprod_kernel  T^T = X_AA^T L_BA^T, stored in X's upper block (rows
//                    A, columns B), which has T^T's shape and is free until
//                    the end; each output tile's depth is cut to the
//                    nonzero tiles of X_AA;
//      xprod_kernel  X_BA = -X_BB T, depth cut to the nonzero tiles of X_BB;
//      each launch covers every pair, output tile and lane, one 128x128
//      output tile per block through tile_ops.cuh's tile_accumulate (8x8
//      outputs a thread, cp.async double-buffered operand slices), the
//      longest blocks first;
//   3. zero_kernel   the tiles above the block diagonal (the levels'
//                    workspace) to exact zeros.
// That is 2 + 2 ceil(log2(n / 128)) launches (14 at n = 5120) for n^3/3
// flops a lane.  Kernels never allocate and never synchronise.
#include "tile_ops.cuh"

namespace {

__global__ void __launch_bounds__(NTHREADS, 1)
leaf_kernel(const float* __restrict__ L, float* __restrict__ X, int n)
{
    extern __shared__ float4 smem4[];
    const TileSmem sm = tile_smem(smem4);
    float* a = sm.a;
    float* x = sm.x;
    const int lane = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
    const int s0 = blockIdx.x * CHOL_TILE;
    const int nb = min(CHOL_TILE, n - s0);
    const float* Ll = L + (size_t)lane * n * n;
    float* Xl = X + (size_t)lane * n * n;

    // the tile's lower triangle, identity past nb; x = 0
    for (int e = tid; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
        const int r = e >> 7, c = e & (CHOL_TILE - 1);
        float v = r == c ? 1.f : 0.f;
        if (r < nb && c <= r) v = Ll[(size_t)(s0 + r) * n + s0 + c];
        a[r * SPAD + c] = v;
        x[r * SPAD + c] = 0.f;
    }
    __syncthreads();
    if (warp < 4) {   // the diagonal blocks' inverses, one warp each
        float* lb = blk(a, warp, warp);
        float* rd = sm.col + warp * kBlk;
        rd[l] = 1.f / lb[l * SPAD + l];
        __syncwarp();
        invert_block(lb, blk(x, warp, warp), rd);
    }
    __syncthreads();
    invert_tile(a, x, sm.t);
    for (int e = tid; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
        const int r = e >> 7, c = e & (CHOL_TILE - 1);
        if (r < nb && c < nb)
            Xl[(size_t)(s0 + r) * n + s0 + c] = x[r * SPAD + c];
    }
}

// Pair p of level w: lo = 2 p w, |B| = min(w, nb - lo - w) tiles.  The
// blocks of a launch cover the pairs in order, (npairs - 1) w^2 output
// tiles for the full pairs, then w |B| for the last one.
__device__ __forceinline__ void pair_of(int t, int w, int nb, int npairs,
                                        int& lo, int& bsz, int& q)
{
    const int p = min(t / (w * w), npairs - 1);
    lo = 2 * p * w;
    bsz = min(w, nb - lo - w);
    q = t - p * w * w;
}

// T^T = X_AA^T L_BA^T: output tile (ci, rj) at rows lo + ci, columns
// lo + w + rj of X; X_AA[k][ci] is zero for k < ci, so the depth runs
// over A's tiles ci.. lo + w.  Longest first (ci = 0).
__global__ void __launch_bounds__(NTHREADS, 2)
tprod_kernel(const float* __restrict__ L, float* __restrict__ X, int n,
             int w, int nb, int npairs)
{
    extern __shared__ float4 smem4[];
    int lo, bsz, q;
    pair_of(blockIdx.x, w, nb, npairs, lo, bsz, q);
    const int ci = q / bsz, rj = q % bsz;
    const int lane = blockIdx.y;
    const int a0 = (lo + ci) * CHOL_TILE, b0 = (lo + w + rj) * CHOL_TILE;
    const int cols = min(CHOL_TILE, n - b0);
    const float* Ll = L + (size_t)lane * n * n;
    float* Xl = X + (size_t)lane * n * n;
    float acc[8][8];
    tile_zero(acc);
    // acc[i][j] = sum_m X[a0 + m][a0 + i] L[b0 + j][a0 + m]
    tile_accumulate<true, false, false>(
        acc, reinterpret_cast<float*>(smem4), Xl + (size_t)a0 * n + a0, n,
        CHOL_TILE, Ll + (size_t)b0 * n + a0, n, cols, (w - ci) * CHOL_TILE,
        0);
    tile_store(Xl + (size_t)a0 * n + b0, n, CHOL_TILE, cols, (n & 3) == 0,
               acc, 1.f);
}

// X_BA = -X_BB T, T[m][c] = X[c][m] (tprod_kernel's T^T): output tile
// (bi, aj) at rows lo + w + bi, columns lo + aj; X_BB[bi][k] is zero for
// k > bi, so the depth runs over B's tiles 0..bi.  Longest first.
__global__ void __launch_bounds__(NTHREADS, 2)
xprod_kernel(float* __restrict__ X, int n, int w, int nb, int npairs)
{
    extern __shared__ float4 smem4[];
    int lo, bsz, q;
    pair_of(blockIdx.x, w, nb, npairs, lo, bsz, q);
    const int bi = bsz - 1 - q / w, aj = q % w;
    const int lane = blockIdx.y;
    const int k0 = (lo + w) * CHOL_TILE;
    const int r0 = k0 + bi * CHOL_TILE, c0 = (lo + aj) * CHOL_TILE;
    const int rows = min(CHOL_TILE, n - r0);
    float* Xl = X + (size_t)lane * n * n;
    float acc[8][8];
    tile_zero(acc);
    // acc[i][j] = sum_m X[r0 + i][k0 + m] X[c0 + j][k0 + m], m < n - k0
    tile_accumulate<false, false, true>(
        acc, reinterpret_cast<float*>(smem4), Xl + (size_t)r0 * n + k0, n,
        rows, Xl + (size_t)c0 * n + k0, n, CHOL_TILE, (bi + 1) * CHOL_TILE,
        n - k0);
    tile_store(Xl + (size_t)r0 * n + c0, n, rows, CHOL_TILE, (n & 3) == 0,
               acc, -1.f);
}

// Zeros in tile (row bj, column bi + 1) for the t-th (bi, bj) of a lower
// triangle of nb - 1 tiles: every tile above the block diagonal.
__global__ void __launch_bounds__(NTHREADS)
zero_kernel(float* __restrict__ X, int n)
{
    int bi, bj;
    tri_decode(blockIdx.x, bi, bj);
    const int r0 = bj * CHOL_TILE, c0 = (bi + 1) * CHOL_TILE;
    const int cols = min(CHOL_TILE, n - c0);
    float* Xl = X + (size_t)blockIdx.y * n * n;
    for (int e = threadIdx.x; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
        const int r = e >> 7, c = e & (CHOL_TILE - 1);
        if (c < cols) Xl[(size_t)(r0 + r) * n + c0 + c] = 0.f;
    }
}

}  // namespace

// K lanes of n x n.  l: input factor (lower triangle read), x: output.
extern "C" int spm_tri_inverse(const void* l, void* x, int K, int n,
                               void* stream)
{
    if (K < 1 || n < 1) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* Lp = static_cast<const float*>(l);
    float* Xp = static_cast<float*>(x);
    const int nb = (n + CHOL_TILE - 1) / CHOL_TILE;
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(leaf_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kTileSmem))) return err;
    if ((err = cudaFuncSetAttribute(tprod_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kProdSmem))) return err;
    if ((err = cudaFuncSetAttribute(xprod_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kProdSmem))) return err;
    leaf_kernel<<<dim3(nb, K), NTHREADS, kTileSmem, s>>>(Lp, Xp, n);
    if ((err = cudaGetLastError())) return err;
    for (int w = 1; w < nb; w *= 2) {
        const int npairs = (nb - w + 2 * w - 1) / (2 * w);
        const int last = min(w, nb - 2 * (npairs - 1) * w - w);
        const dim3 grid((npairs - 1) * w * w + w * last, K);
        tprod_kernel<<<grid, NTHREADS, kProdSmem, s>>>(Lp, Xp, n, w, nb,
                                                       npairs);
        xprod_kernel<<<grid, NTHREADS, kProdSmem, s>>>(Xp, n, w, nb, npairs);
        if ((err = cudaGetLastError())) return err;
    }
    if (nb > 1)
        zero_kernel<<<dim3(nb * (nb - 1) / 2, K), NTHREADS, 0, s>>>(Xp, n);
    return cudaGetLastError();
}
