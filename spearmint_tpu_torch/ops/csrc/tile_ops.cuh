// Shared building blocks of the Cholesky-family kernels (shifted_chol.cu,
// tri_inverse.cu): the panel width, the 64x64 tile inversion in shared
// memory, and a deterministic block reduction.
//
// Every tile is PANEL x PANEL floats, stored with one float of row
// padding (PANEL + 1) where it is walked column-wise, and PANEL + 4 where
// the inner product reads it as float4 rows (rows stay 16-byte aligned).
#pragma once

#include <cuda_runtime.h>

#define PANEL 64
#define NTHREADS 256
#define TPAD (PANEL + 4)

// x <- L^{-1} for the lower-triangular PANEL x PANEL tile in `a` (only its
// lower triangle is read).  Column-parallel forward substitution: four
// threads own one column c and split each inner sum, so a column never
// waits on another one and the loop needs no block barrier.  Exact zeros
// above the diagonal.  Caller syncs the block before reading x.
__device__ __forceinline__ void invert_lower_tile(
    const float (*a)[PANEL + 1], float (*x)[PANEL + 1])
{
    const int tid = threadIdx.x;
    const int c = tid >> 2;      // NTHREADS / 4 == PANEL columns
    const int part = tid & 3;
    for (int r = 0; r < PANEL; ++r) {
        float s = 0.f;
        for (int m = c + part; m < r; m += 4) s += a[r][m] * x[m][c];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        float v;
        if (r < c) v = 0.f;
        else if (r == c) v = 1.f / a[r][r];
        else v = -s / a[r][r];
        if (part == 0) x[r][c] = v;
        __syncwarp();
    }
}

// Sum of one float per thread over the block, in a fixed order (warp
// shuffles, then warp 0 over the per-warp sums).  Result valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = 0.f;
    if (warp == 0) {
        v = lane < NTHREADS / 32 ? scratch[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}
