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
// b <= 128 and a multiple of 4.  Each level eliminates every odd block
// row at once (they are mutually uncoupled) and Schur-updates the even
// ones; with G1 = L^{-1} B_left, G2 = L^{-1} B_right^T and g = L^{-1} r_odd
// (L = chol(A_odd)):
//   A_even[j]  -= G1[j]^T G1[j] + G2[j-1]^T G2[j-1]
//   r_even[j]  -= G1[j]^T g[j]  + G2[j-1]^T g[j-1]
//   B_new[j]    = -G2[j]^T G1[j]
//   ld += sum log diag L,   q += |g|^2,
// and the last block is factored at the end.  Exact block Gaussian
// elimination under a nested-dissection order, so ld and q are those of
// the whole matrix.
//
// What bounds it on an H100: per eliminated block, b^3/3 (Cholesky) +
// (2b+1) b^2 (the triangular solve of the 2b+1 right-hand sides) + 6 b^3
// (three b x b x b products) flops, in f32 on the CUDA cores (no TF32:
// the sampler reads lp in full f32), 1.1e10 flop at [10, 64, 128, 128],
// 0.16 ms at 67 TFLOP/s; its inputs are 84 MB, 0.03 ms at 3.35 TB/s.  Far
// above both sits the serial chain of log2(m) + 1 dependent b-column
// Choleskys, each one block's work.
//
// Design: a host loop of two launches per level over global memory (no
// whole-problem residency, which on the TPU needed 127 MB of VMEM):
//   1. eliminate_kernel  one block per (lane, odd row): A_odd factored in
//                        dynamic shared memory (pivot d2 * rsqrt(d2), so a
//                        non-PD block gives NaN, never +-inf), then the
//                        b x (2b+1) right-hand side [B_left | B_right^T |
//                        r_odd] forward-substituted in place, one column
//                        per thread (a TRSM, not an explicit inverse);
//                        G1, G2, g to scratch, the block's partial ld and q
//                        to a [K, m] slot array;
//   2. update_kernel     one block per (lane, even row, 64 x 64 output
//                        tile): the three products in FFMA from shared
//                        memory, 4 x 4 outputs per thread, written in place
//                        into the even blocks of the working copies.
// Level l keeps its active block p at index p << l of the working copies,
// so nothing is compacted.  A last reduce_kernel sums each lane's m slots
// in a fixed order (no atomics): lp is bit-identical from run to run.
// Inert identity blocks (a = I, bb = 0, r = 0) factor to I and add exactly
// 0; a non-PD lane gives NaN in its own ld and q only.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;              // update_kernel's output tile
constexpr int kChunk = 32;             // and its k-chunk
constexpr int kUpdThreads = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTpad = kTile + 4;       // float4 rows stay 16-byte aligned

__device__ __forceinline__ float block_sum(float v, float* scratch)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    __syncthreads();
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = 0.f;
    if (warp == 0) {
        v = lane < nwarps ? scratch[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}

// One block per (odd row i, lane), or with final != 0 the one remaining
// block (index 0) of each lane with r as its only right-hand side.
// blockDim.x >= 2b + 1 and a multiple of 32.
__global__ void eliminate_kernel(const float* __restrict__ A,
                                 const float* __restrict__ BB,
                                 const float* __restrict__ R,
                                 float* __restrict__ G1,
                                 float* __restrict__ G2,
                                 float* __restrict__ g,
                                 float* __restrict__ part_ld,
                                 float* __restrict__ part_q,
                                 int m, int b, int lvl, int h, int slot0,
                                 int final_)
{
    extern __shared__ float sm[];
    __shared__ float red[32];
    const int ldl = b + 1;
    const int nrhs = final_ ? 1 : 2 * b + 1;
    const int ldx = nrhs;                  // odd: conflict-free both ways
    float* L = sm;                         // [b][b + 1]
    float* X = sm + b * ldl;               // [b][nrhs]
    const int i = blockIdx.x, lane = blockIdx.y;
    const int tid = threadIdx.x, nt = blockDim.x;
    const size_t bb2 = (size_t)b * b;
    const int odd = final_ ? 0 : (2 * i + 1) << lvl;
    const int left = (2 * i) << lvl;
    const float* Ab = A + ((size_t)lane * m + odd) * bb2;
    const float* Rb = R + ((size_t)lane * m + odd) * b;

    for (int e = tid; e < b * b; e += nt) {
        const int r = e / b, c = e % b;
        L[r * ldl + c] = c <= r ? Ab[e] : 0.f;
    }
    if (final_) {
        for (int r = tid; r < b; r += nt) X[r * ldx] = Rb[r];
    } else {
        const float* Bl = BB + ((size_t)lane * m + left) * bb2;
        const float* Br = BB + ((size_t)lane * m + odd) * bb2;
        for (int e = tid; e < b * b; e += nt) {
            const int r = e / b, c = e % b;
            X[r * ldx + c] = Bl[e];        // B_left
            X[c * ldx + b + r] = Br[e];    // B_right^T, read in source order
        }
        for (int r = tid; r < b; r += nt) X[r * ldx + 2 * b] = Rb[r];
    }
    __syncthreads();

    // unblocked right-looking Cholesky of the block (lower triangle only)
    for (int j = 0; j < b; ++j) {
        const float d2 = L[j * ldl + j];
        const float inv = rsqrtf(d2);
        __syncthreads();
        if (tid == j) L[j * ldl + j] = d2 * inv;
        else if (tid > j && tid < b) L[tid * ldl + j] *= inv;
        __syncthreads();
        const int w = b - 1 - j;
        for (int e = tid; e < w * w; e += nt) {
            const int r = j + 1 + e / w, c = j + 1 + e % w;
            if (c <= r) L[r * ldl + c] -= L[r * ldl + j] * L[c * ldl + j];
        }
        __syncthreads();
    }

    // X <- L^{-1} X, one column per thread, in place
    for (int c = tid; c < nrhs; c += nt) {
        for (int r = 0; r < b; ++r) {
            float s = X[r * ldx + c];
            for (int k = 0; k < r; ++k) s -= L[r * ldl + k] * X[k * ldx + c];
            X[r * ldx + c] = s / L[r * ldl + r];
        }
    }
    __syncthreads();

    float lg = 0.f, sq = 0.f;
    if (tid < b) {
        lg = logf(L[tid * ldl + tid]);
        const float gv = X[tid * ldx + nrhs - 1];
        sq = gv * gv;
    }
    lg = block_sum(lg, red);
    const int slot = lane * m + slot0 + i;
    if (tid == 0) part_ld[slot] = lg;
    sq = block_sum(sq, red);
    if (tid == 0) part_q[slot] = sq;
    if (final_) return;

    const size_t gi = (size_t)lane * h + i;
    float* g1 = G1 + gi * bb2;
    float* g2 = G2 + gi * bb2;
    for (int e = tid; e < b * b; e += nt) {
        const int r = e / b, c = e % b;
        g1[e] = X[r * ldx + c];
        g2[e] = X[r * ldx + b + c];
    }
    for (int r = tid; r < b; r += nt) g[gi * b + r] = X[r * ldx + 2 * b];
}

// acc[ii][jj] += sum_k P[k][r0 + 4ty + ii] * Q[k][c0 + 4tx + jj] (P^T Q)
// over k < b, for b x b row-major P and Q; out-of-range rows and columns
// read as zero.
__device__ __forceinline__ void acc_tn(float (&acc)[4][4],
                                       const float* __restrict__ P,
                                       const float* __restrict__ Q,
                                       int b, int r0, int c0,
                                       float (*ps)[kTpad], float (*qs)[kTpad])
{
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    for (int k0 = 0; k0 < b; k0 += kChunk) {
        __syncthreads();
        for (int e = tid; e < kChunk * kTile; e += kUpdThreads) {
            const int kk = e / kTile, cc = e % kTile, k = k0 + kk;
            ps[kk][cc] = k < b && r0 + cc < b ? P[(size_t)k * b + r0 + cc] : 0.f;
            qs[kk][cc] = k < b && c0 + cc < b ? Q[(size_t)k * b + c0 + cc] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kChunk; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(&ps[kk][ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&qs[kk][tx * 4]);
            const float a4[4] = {av.x, av.y, av.z, av.w};
            const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += a4[ii] * b4[jj];
        }
    }
}

// One block per (even row j, output tile, lane): grid.x = h * tiles^2.
__global__ void __launch_bounds__(kUpdThreads)
update_kernel(float* __restrict__ A, float* __restrict__ BB,
              float* __restrict__ R, const float* __restrict__ G1,
              const float* __restrict__ G2, const float* __restrict__ g,
              int m, int b, int lvl, int h, int tiles)
{
    __shared__ __align__(16) float ps[kChunk][kTpad];
    __shared__ __align__(16) float qs[kChunk][kTpad];
    const int lane = blockIdx.y;
    const int j = blockIdx.x / (tiles * tiles);
    const int t = blockIdx.x % (tiles * tiles);
    const int r0 = (t / tiles) * kTile, c0 = (t % tiles) * kTile;
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const size_t bb2 = (size_t)b * b;
    const size_t gj = (size_t)lane * h + j;
    const int even = (2 * j) << lvl;

    float acc_a[4][4] = {}, acc_b[4][4] = {};
    acc_tn(acc_a, G1 + gj * bb2, G1 + gj * bb2, b, r0, c0, ps, qs);
    if (j > 0)
        acc_tn(acc_a, G2 + (gj - 1) * bb2, G2 + (gj - 1) * bb2, b, r0, c0,
               ps, qs);
    acc_tn(acc_b, G2 + gj * bb2, G1 + gj * bb2, b, r0, c0, ps, qs);

    float* Ae = A + ((size_t)lane * m + even) * bb2;
    float* Be = BB + ((size_t)lane * m + even) * bb2;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
        const int r = r0 + ty * 4 + ii;
        if (r >= b) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int c = c0 + tx * 4 + jj;
            if (c < b) {
                Ae[(size_t)r * b + c] -= acc_a[ii][jj];
                Be[(size_t)r * b + c] = -acc_b[ii][jj];
            }
        }
    }

    // r_even[j] -= G1[j]^T g[j] + G2[j-1]^T g[j-1], by the first tile column
    if (c0 == 0 && tid < kTile && r0 + tid < b) {
        const int r = r0 + tid;
        const float* g1 = G1 + gj * bb2;
        const float* gv = g + gj * b;
        float s = 0.f;
        for (int k = 0; k < b; ++k) s += g1[(size_t)k * b + r] * gv[k];
        if (j > 0) {
            const float* g2 = G2 + (gj - 1) * bb2;
            const float* gp = g + (gj - 1) * b;
            for (int k = 0; k < b; ++k) s += g2[(size_t)k * b + r] * gp[k];
        }
        R[((size_t)lane * m + even) * b + r] -= s;
    }
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

// K lanes of m blocks of b x b.  a, bb [K,m,b,b] and r [K,m*b]: inputs
// (read only).  ws: a float workspace of at least
//   2 K m b^2 + K m b   (working copies of a, bb, r)
// + K m b^2 + K (m/2) b (G1, G2, g)
// + 2 K m             (partial ld and q)
// floats, ws_floats its size.  ld, q [K]: outputs.
extern "C" int spm_cyclic_reduction(const void* a, const void* bb,
                                    const void* r, void* ws, void* ld,
                                    void* q, int K, int m, int b,
                                    long long ws_floats, void* stream)
{
    if (K < 1 || m < 2 || (m & (m - 1)) || b < 4 || b > 128 || b % 4)
        return cudaErrorInvalidValue;
    const size_t bb2 = (size_t)b * b, km = (size_t)K * m;
    const size_t need = 3 * km * bb2 + km * b + km / 2 * b + 2 * km;
    if ((size_t)ws_floats < need) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* W = static_cast<float*>(ws);
    float* A = W;
    float* BB = A + km * bb2;
    float* R = BB + km * bb2;
    float* G1 = R + km * b;
    float* G2 = G1 + km / 2 * bb2;
    float* G = G2 + km / 2 * bb2;
    float* PL = G + km / 2 * b;
    float* PQ = PL + km;
    cudaError_t err;
    if ((err = cudaMemcpyAsync(A, a, km * bb2 * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemcpyAsync(BB, bb, km * bb2 * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;
    if ((err = cudaMemcpyAsync(R, r, km * b * sizeof(float),
                               cudaMemcpyDeviceToDevice, s))) return err;

    const int nt = ((2 * b + 1 + 31) / 32) * 32;
    const size_t smem = ((size_t)b * (b + 1) + (size_t)b * (2 * b + 1))
                        * sizeof(float);
    if ((err = cudaFuncSetAttribute(
             eliminate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem))) return err;
    const int tiles = (b + kTile - 1) / kTile;
    int lvl = 0;
    for (int mc = m; mc > 1; mc >>= 1, ++lvl) {
        const int h = mc / 2;
        eliminate_kernel<<<dim3(h, K), nt, smem, s>>>(
            A, BB, R, G1, G2, G, PL, PQ, m, b, lvl, h, m - mc, 0);
        update_kernel<<<dim3(h * tiles * tiles, K), kUpdThreads, 0, s>>>(
            A, BB, R, G1, G2, G, m, b, lvl, h, tiles);
        if ((err = cudaGetLastError())) return err;
    }
    const size_t smem_f = ((size_t)b * (b + 1) + b) * sizeof(float);
    eliminate_kernel<<<dim3(1, K), nt, smem_f, s>>>(
        A, BB, R, G1, G2, G, PL, PQ, m, b, 0, 1, m - 1, 1);
    reduce_kernel<<<(K + 127) / 128, 128, 0, s>>>(
        PL, PQ, static_cast<float*>(ld), static_cast<float*>(q), K, m);
    return cudaGetLastError();
}
