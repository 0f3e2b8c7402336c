// Block cyclic reduction of a batch of block-tridiagonal SPD matrices:
// per lane, ld = sum log diag chol(K) and q = r^T K^{-1} r.  Kernel B5 of
// the port, the band-mode joint move's evaluation.
//
// Replaces (TPU, Pallas): spearmint_tpu/ops/band.py:409
//   cr_logdet_q_pallas (pallas_call :440, body _cr_body :338).
//
// Input, per lane: diagonal blocks a [m, b, b] (assembled, SPD), coupling
// blocks bb [m, b, b] (bb[i] is the (i+1, i) block; the last slot is
// never read into the result) and r [m * b]; m a power of two >= 2,
// b <= 128 and a multiple of 4.  Blocks n_real.. are inert padding
// (identity, zero coupling, r = 0).  Each level eliminates every odd block
// row at once (they are mutually uncoupled) and Schur-updates the even
// ones; with X = L^{-1} (L = chol(A_odd)), G1 = X B_left, G2 = X B_right^T
// and g = X r_odd:
//   A_even[j]  -= G1[j]^T G1[j] + G2[j-1]^T G2[j-1]
//   r_even[j]  -= G1[j]^T g[j]  + G2[j-1]^T g[j-1]
//   B_new[j]    = -G2[j]^T G1[j]
//   ld += sum log diag L,   q += |g|^2,
// and the last block is factored at the end.  Exact block Gaussian
// elimination under a nested-dissection order, so ld and q are those of
// the whole matrix.
//
// What bounds it on an H100: per eliminated block about 10.7 b^3 flops
// (b^3/3 each for the factor and L^{-1}, 4 b^3 for the two products by
// L^{-1}, 6 b^3 for the three products of the update), in f32 on the CUDA
// cores (no TF32: the sampler reads lp in full f32): 8.7e9 flop at
// [10, 64, 128, 128] with 40 real blocks, 0.13 ms at 67 TFLOP/s; its
// inputs are 84 MB, 0.03 ms at 3.35 TB/s.  Far above both sits the chain
// of log2(m) + 1 dependent b-column factorizations, each one block's
// work, and each level's three dependent launches.
//
// Design: a host loop of three launches per level over global memory, on
// tile_ops.cuh's routines (the 128x128 tile of B1's diagonal step and its
// tile product), every launch over (block, lane):
//   1. factor_kernel  one block per real odd row: A_odd in dynamic shared
//                     memory, padded with identity to 128, factored by the
//                     warp-owned 32x32 blocks (pivot d2 * rsqrt(d2), so a
//                     non-PD block gives NaN, never +-inf) and inverted by
//                     2x2 block recursion (factor_tile, invert_tile);
//                     g = X r_odd; X and g to scratch, the block's partial
//                     ld and q to a [K, m] slot array.  The explicit
//                     inverse keeps the chain at one 128-wide tile step;
//                     its float32 error is that of the reference's own
//                     schedule (ROADMAP C3);
//   2. solve_kernel   G1 = X B_left and G2 = X B_right^T, one 128x128
//                     product each (tile_accumulate: 8x8 outputs a thread,
//                     cp.async double-buffered slices, b masked);
//   3. update_kernel  per real even row, one block for A_even (the two
//                     products into one accumulator) and r_even (a GEMV
//                     over 256 threads, two halves summed in a fixed
//                     order), one for B_new.
// Level l keeps its active block p at index p << l of the working copies,
// so nothing is compacted.  Blocks at or past n_real are skipped: they
// stay identity with zero coupling at every level, and their slots hold
// an exact 0, which is what they would add.  A last reduce_kernel sums
// each lane's m slots in a fixed order (no atomics): lp is bit-identical
// from run to run, and with or without inert padding.  A non-PD lane gives
// NaN in its own ld and q only.
#include "tile_ops.cuh"

namespace {

// One block per real odd row i of level lvl, or with final != 0 the one
// remaining block (index 0) of each lane.  Slot slot0 + i of the lane.
__global__ void __launch_bounds__(NTHREADS, 1)
factor_kernel(const float* __restrict__ A, const float* __restrict__ R,
              float* __restrict__ Xw, float* __restrict__ gw,
              float* __restrict__ part_ld, float* __restrict__ part_q,
              int m, int b, int lvl, int h, int slot0, int final_)
{
    extern __shared__ float4 smem4[];
    const TileSmem sm = tile_smem(smem4);
    float* a = sm.a;
    float* x = sm.x;
    const int i = blockIdx.x, lane = blockIdx.y;
    const int tid = threadIdx.x;
    const size_t bb2 = (size_t)b * b;
    const int odd = final_ ? 0 : (2 * i + 1) << lvl;
    const float* Ab = A + ((size_t)lane * m + odd) * bb2;

    // the block (rows and columns past b zero, identity on the diagonal
    // past b), x = 0; b % 4 == 0, so rows are float4-aligned
#pragma unroll
    for (int it = 0; it < CHOL_TILE * CHOL_TILE / 4 / NTHREADS; ++it) {
        const int e = it * NTHREADS + tid;
        const int r = e >> 5, c = (e & 31) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < b && c < b)
            v = *reinterpret_cast<const float4*>(Ab + (size_t)r * b + c);
        *reinterpret_cast<float4*>(a + r * SPAD + c) = v;
        *reinterpret_cast<float4*>(x + r * SPAD + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (tid < CHOL_TILE)
        sm.v[tid] = tid < b ? R[((size_t)lane * m + odd) * b + tid] : 0.f;
    __syncthreads();
    if (tid >= b && tid < CHOL_TILE) a[tid * SPAD + tid] = 1.f;
    __syncthreads();

    factor_tile(a, x, sm.col);
    invert_tile(a, x, sm.t);

    const size_t gi = (size_t)lane * h + i;
    float lg = 0.f, sq = 0.f;
    // (the last block's g is not kept: t is free after invert_tile)
    tile_solve(a, x, sm.v, final_ ? sm.t : gw + gi * b, b, lg, sq);
    lg = block_sum(lg, sm.red);
    const size_t slot = (size_t)lane * m + slot0 + i;
    if (tid == 0) part_ld[slot] = lg;
    sq = block_sum(sq, sm.red);
    if (tid == 0) part_q[slot] = sq;
    if (final_) return;

    float* xo = Xw + gi * bb2;
    for (int e = tid; e < b * b; e += NTHREADS) {
        const int r = e / b, c = e - r * b;
        xo[e] = x[r * SPAD + c];
    }
}

// Blocks (i, which): which 0 gives G1 = X B_left, 1 gives G2 = X B_right^T
// (not for the level's last odd row, whose G2 feeds nothing).
__global__ void __launch_bounds__(NTHREADS, 2)
solve_kernel(const float* __restrict__ BB, const float* __restrict__ Xw,
             float* __restrict__ G1, float* __restrict__ G2, int m, int b,
             int lvl, int h)
{
    extern __shared__ float4 smem4[];
    const int i = blockIdx.x >> 1, which = blockIdx.x & 1;
    if (which == 1 && i == h - 1) return;
    const int lane = blockIdx.y;
    const size_t bb2 = (size_t)b * b;
    const size_t gi = (size_t)lane * h + i;
    const int depth = (b + KSLICE - 1) / KSLICE * KSLICE;
    float* smem = reinterpret_cast<float*>(smem4);
    float acc[8][8];
    tile_zero(acc);
    if (which == 0) {   // G1[r][c] = sum_m X[r][m] B_left[m][c]
        const float* bl = BB + ((size_t)lane * m + ((2 * i) << lvl)) * bb2;
        tile_accumulate<false, true, true>(acc, smem, Xw + gi * bb2, b, b,
                                           bl, b, b, depth, b);
    } else {            // G2[r][c] = sum_m X[r][m] B_right[c][m]
        const float* br = BB + ((size_t)lane * m + ((2 * i + 1) << lvl)) * bb2;
        tile_accumulate<false, false, true>(acc, smem, Xw + gi * bb2, b, b,
                                            br, b, b, depth, b);
    }
    tile_store((which == 0 ? G1 : G2) + gi * bb2, b, b, b, true, acc, 1.f);
}

// Blocks (j, kind) for the level's real even rows j < neven; nodd odd rows
// are real (G1[j] exists for j < nodd, G2[j - 1] for 1 <= j <= nodd).
// kind 0: A_even[j] -= G1[j]^T G1[j] + G2[j-1]^T G2[j-1] and r_even[j];
// kind 1: B_new[j] = -G2[j]^T G1[j] (j < nodd and j < h - 1).
__global__ void __launch_bounds__(NTHREADS, 2)
update_kernel(float* __restrict__ A, float* __restrict__ BB,
              float* __restrict__ R, const float* __restrict__ G1,
              const float* __restrict__ G2, const float* __restrict__ gw,
              int m, int b, int lvl, int h, int nodd)
{
    extern __shared__ float4 smem4[];
    const int j = blockIdx.x >> 1, kind = blockIdx.x & 1;
    const bool has1 = j < nodd, has2 = j >= 1 && j - 1 < nodd;
    if (kind == 1 && !(has1 && j < h - 1)) return;
    const int lane = blockIdx.y, tid = threadIdx.x;
    const size_t bb2 = (size_t)b * b;
    const size_t gj = (size_t)lane * h + j;
    const size_t even = (size_t)lane * m + ((2 * j) << lvl);
    const int depth = (b + KSLICE - 1) / KSLICE * KSLICE;
    float* smem = reinterpret_cast<float*>(smem4);
    float acc[8][8];
    tile_zero(acc);
    if (kind == 1) {   // B_new[r][c] = -sum_m G2[m][r] G1[m][c]
        tile_accumulate<true, true, true>(acc, smem, G2 + gj * bb2, b, b,
                                          G1 + gj * bb2, b, b, depth, b);
        tile_store(BB + even * bb2, b, b, b, true, acc, -1.f);
        return;
    }
    // (G^T G)[r][c] = sum_m G[m][r] G[m][c], both terms in one accumulator
    if (has1)
        tile_accumulate<true, true, true>(acc, smem, G1 + gj * bb2, b, b,
                                          G1 + gj * bb2, b, b, depth, b);
    if (has2)
        tile_accumulate<true, true, true>(acc, smem, G2 + (gj - 1) * bb2, b,
                                          b, G2 + (gj - 1) * bb2, b, b,
                                          depth, b);
    float* Ae = A + even * bb2;
    const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
        const int r = row_of(ty, ii);
        if (r >= b) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int c = 64 * hh + tx * 4;
            if (c < b) {
                float4 v = *reinterpret_cast<float4*>(Ae + (size_t)r * b + c);
                v.x -= acc[ii][4 * hh];
                v.y -= acc[ii][4 * hh + 1];
                v.z -= acc[ii][4 * hh + 2];
                v.w -= acc[ii][4 * hh + 3];
                *reinterpret_cast<float4*>(Ae + (size_t)r * b + c) = v;
            }
        }
    }

    // r_even[j][c] -= sum_m G1[j][m][c] g[j][m] + sum_m G2[j-1][m][c]
    // g[j-1][m]: threads 0-127 the first sum, 128-255 the second, column
    // c = tid % 128 each (coalesced rows of G), then the two added in order
    float* gv = smem;                  // [2][128]: g[j], g[j - 1]
    float* part = smem + 2 * CHOL_TILE;   // [256]
    const int c = tid & (CHOL_TILE - 1), half = tid >> 7;
    const bool on = half == 0 ? has1 : has2;
    if (c < b)
        gv[tid] = on ? gw[(gj - half) * b + c] : 0.f;
    __syncthreads();
    float s = 0.f;
    if (on && c < b) {
        const float* G = half == 0 ? G1 + gj * bb2 : G2 + (gj - 1) * bb2;
        const float* v = gv + half * CHOL_TILE;
#pragma unroll 8
        for (int k = 0; k < b; ++k) s = fmaf(G[(size_t)k * b + c], v[k], s);
    }
    part[tid] = s;
    __syncthreads();
    if (tid < b) R[even * b + tid] -= part[tid] + part[CHOL_TILE + tid];
}

// ld[lane] and q[lane]: each lane's m slots summed in slot order.
__global__ void reduce_kernel(const float* __restrict__ part_ld,
                              const float* __restrict__ part_q,
                              float* __restrict__ ld, float* __restrict__ q,
                              int K, int m)
{
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= K) return;
    float sl = 0.f, sq = 0.f;
    for (int s = 0; s < m; ++s) {
        sl += part_ld[(size_t)lane * m + s];
        sq += part_q[(size_t)lane * m + s];
    }
    ld[lane] = sl;
    q[lane] = sq;
}

}  // namespace

// K lanes of m blocks of b x b, the first n_real real.  a, bb [K,m,b,b]
// and r [K,m*b]: inputs (read only; blocks past n_real are never read).
// ws: a float workspace of at least
//   2 K m b^2 + K m b           (working copies of a, bb, r)
// + 3 K (m/2) b^2 + K (m/2) b   (X, G1, G2, g)
// + 2 K m                       (partial ld and q)
// floats, ws_floats its size.  ld, q [K]: outputs.
extern "C" int spm_cyclic_reduction(const void* a, const void* bb,
                                    const void* r, void* ws, void* ld,
                                    void* q, int K, int m, int b, int n_real,
                                    long long ws_floats, void* stream)
{
    if (K < 1 || m < 2 || (m & (m - 1)) || b < 4 || b > CHOL_TILE || b % 4
        || n_real < 1 || n_real > m)
        return cudaErrorInvalidValue;
    const size_t bb2 = (size_t)b * b, km = (size_t)K * m, kh = km / 2;
    const size_t need = 2 * km * bb2 + km * b + 3 * kh * bb2 + kh * b + 2 * km;
    if ((size_t)ws_floats < need) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* W = static_cast<float*>(ws);
    float* A = W;
    float* BB = A + km * bb2;
    float* R = BB + km * bb2;
    float* X = R + km * b;
    float* G1 = X + kh * bb2;
    float* G2 = G1 + kh * bb2;
    float* G = G2 + kh * bb2;
    float* PL = G + kh * b;
    float* PQ = PL + km;
    cudaError_t err;
    // working copies of the real blocks only; every slot starts at 0
    const size_t pitch = m * bb2 * sizeof(float);
    if ((err = cudaMemcpy2DAsync(A, pitch, a, pitch,
                                 n_real * bb2 * sizeof(float), K,
                                 cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemcpy2DAsync(BB, pitch, bb, pitch,
                                 n_real * bb2 * sizeof(float), K,
                                 cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemcpy2DAsync(R, m * b * sizeof(float), r,
                                 m * b * sizeof(float),
                                 n_real * b * sizeof(float), K,
                                 cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemsetAsync(PL, 0, 2 * km * sizeof(float), s))) return err;
    if ((err = cudaFuncSetAttribute(
             factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)kTileSmem))) return err;
    if ((err = cudaFuncSetAttribute(
             solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)kProdSmem))) return err;
    if ((err = cudaFuncSetAttribute(
             update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)kProdSmem))) return err;

    int lvl = 0;
    for (int mc = m; mc > 1; mc >>= 1, ++lvl) {
        const int h = mc / 2;
        // the active blocks p (at index p << lvl) that are real:
        // p < ceil(n_real / 2^lvl)
        const int nr = (n_real + (1 << lvl) - 1) >> lvl;
        const int nodd = nr / 2, neven = (nr + 1) / 2;
        if (nodd == 0) continue;
        factor_kernel<<<dim3(nodd, K), NTHREADS, kTileSmem, s>>>(
            A, R, X, G, PL, PQ, m, b, lvl, h, m - mc, 0);
        solve_kernel<<<dim3(2 * nodd, K), NTHREADS, kProdSmem, s>>>(
            BB, X, G1, G2, m, b, lvl, h);
        update_kernel<<<dim3(2 * neven, K), NTHREADS, kProdSmem, s>>>(
            A, BB, R, G1, G2, G, m, b, lvl, h, nodd);
        if ((err = cudaGetLastError())) return err;
    }
    factor_kernel<<<dim3(1, K), NTHREADS, kTileSmem, s>>>(
        A, R, X, G, PL, PQ, m, b, 0, 1, m - 1, 1);
    reduce_kernel<<<(K + 127) / 128, 128, 0, s>>>(
        PL, PQ, static_cast<float*>(ld), static_cast<float*>(q), K, m);
    return cudaGetLastError();
}
