// Device routines shared by the port's kernels: shifted_chol.cu (B1, B2,
// B4a, B4b), tri_inverse.cu (B3) and cyclic_reduction.cu (B5).  B1-B4b's
// trailing update no longer uses tile_product: shifted_chol.cu's
// trailing_kernel has its own loop, over operands that are already
// depth-major in device memory; its panel step, B3 and B5 still use it.
//
// Every kernel works on 128x128 tiles (CHOL_TILE) with 256 threads:
//   * tile_product / tile_accumulate: a 128x128 output tile, 8x8 outputs
//     per thread in registers, operands staged through shared memory in
//     32-deep k-slices (KSLICE) that cp.async double-buffers, so the next
//     slice's copy overlaps this slice's FMAs.  Staged operands are stored
//     k-major (s[m][r], row pitch SPAD = 132: conflict-free transposing
//     4-byte copies, 16-byte aligned rows for float4 reads).  An operand
//     is read either with its depth index contiguous in memory (row-major
//     A in A B^T: load_slice) or with its output index contiguous (row-
//     major B in A B: load_slice_t); either may zero-fill a ragged depth.
//   * factor_tile / invert_tile: a 128x128 tile in shared memory as 4x4
//     blocks of 32x32 (CHOL_SUB), each owned by one warp at a time: the
//     lane keeps one row of a block in registers and reads the other
//     operand as float4 broadcasts.  factor_tile is a right-looking
//     Cholesky by block columns (one warp factors and inverts the
//     diagonal block, no block barrier per column); invert_tile builds
//     L^{-1} from the blocks' inverses by 2x2 block recursion,
//     X_BA = -X_BB (L_BA X_AA), pairs of blocks first, then the halves.
//   * block_sum: a deterministic sum over the block.
#pragma once

#include <cuda_runtime.h>

#define NTHREADS 256
#define CHOL_TILE 128     // tile width; gp_kernels.CHOL_TILE
#define CHOL_SUB 32       // warp block of a diagonal tile; gp_kernels.CHOL_SUB
#define KSLICE 32         // depth of one staged operand slice
#define SPAD (CHOL_TILE + 4)   // pitch of staged operands and of a tile
#define TT (CHOL_SUB + 4)      // pitch of the inverse's 32x32 products

static_assert(NTHREADS == 256, "8x8 outputs per thread cover 128x128");
static_assert(CHOL_TILE == 4 * CHOL_SUB, "the tile is 4x4 blocks");

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlk = CHOL_SUB;   // 32: a warp's block
// two stages of both operands of tile_product
constexpr size_t kProdSmem = 4 * KSLICE * SPAD * sizeof(float);

// Sum of one float per thread over the block, in a fixed order (warp
// shuffles, then warp 0 over the per-warp sums).  Result valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch)
{
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = 0.f;
    if (warp == 0) {
        v = lane < NTHREADS / 32 ? scratch[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(kFull, v, o);
    }
    return v;
}

// ------------------------------------------------------ asynchronous copies
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// s[m][r] <- g[r * ld + k + m] for a 128-row x KSLICE slice of an operand
// whose depth index is contiguous; rows >= nrows are zero-filled, and with
// kMask so are depths k + m >= kmax.  A warp copies 4 rows x 8 columns
// (32-byte runs of each row); its stores hit 32 distinct banks because
// SPAD = 4 (mod 32).
template <bool kMask = false>
__device__ __forceinline__ void load_slice(float* s, const float* g, int ld,
                                           int nrows, int k, int kmax = 0)
{
    const int m = threadIdx.x & 7, r = threadIdx.x >> 3;   // r < 32
    const float* src[4];
    bool ok[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
        const int rr = r + 32 * h;
        ok[h] = rr < nrows;
        src[h] = g + (size_t)(ok[h] ? rr : 0) * ld + k + m;
    }
#pragma unroll
    for (int it = 0; it < 16; ++it) {
        const int h = it & 3, mm = 8 * (it >> 2);
        if constexpr (kMask) {
            const bool full = ok[h] && k + m + mm < kmax;
            cp_async4(s + (m + mm) * SPAD + r + 32 * h,
                      full ? src[h] + mm : g, full);
        } else {
            cp_async4(s + (m + mm) * SPAD + r + 32 * h, src[h] + mm, ok[h]);
        }
    }
}

// s[m][c] <- g[(k + m) * ld + c] for a KSLICE x 128-column slice of an
// operand whose output index is contiguous (no transposition); columns
// >= ncols are zero-filled, and with kMask so are depths k + m >= kmax.
// A warp copies 32 consecutive columns of one depth row: coalesced reads,
// conflict-free stores.
template <bool kMask = false>
__device__ __forceinline__ void load_slice_t(float* s, const float* g,
                                             int ld, int ncols, int k,
                                             int kmax = 0)
{
    const int c = threadIdx.x & (CHOL_TILE - 1), m0 = threadIdx.x >> 7;
    const bool okc = c < ncols;
#pragma unroll
    for (int it = 0; it < KSLICE / 2; ++it) {
        const int m = m0 + 2 * it;
        const bool full = okc && (!kMask || k + m < kmax);
        cp_async4(s + m * SPAD + c, full ? g + (size_t)(k + m) * ld + c : g,
                  full);
    }
}

template <bool kT, bool kMask>
__device__ __forceinline__ void load_operand(float* s, const float* g,
                                             int ld, int rows, int k,
                                             int kmax)
{
    if constexpr (kT) load_slice_t<kMask>(s, g, ld, rows, k, kmax);
    else load_slice<kMask>(s, g, ld, rows, k, kmax);
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows row_of(ty, i) and
// columns row_of(tx, j) for i, j < 8: two runs of 4, 64 apart.
__device__ __forceinline__ int row_of(int t, int i)
{
    return (i < 4 ? 0 : 60) + t * 4 + i;
}

__device__ __forceinline__ void tile_zero(float (&acc)[8][8])
{
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{m < depth} A(row_of(ty, i), m) * B(row_of(tx, j), m)
// on a 128x128 tile.  Operand A's element (r, m) is ag[r * lda + m], or
// with kAT ag[m * lda + r]; likewise B with kBT.  Rows (r) >= arows,
// >= brows read as 0, and with kMask depths m >= kmax too.  depth is a
// positive multiple of KSLICE.  smem holds two stages of both operands
// (kProdSmem bytes); the routine ends with a block barrier, so smem may
// be reused right after it.
template <bool kAT, bool kBT, bool kMask>
__device__ __forceinline__ void tile_accumulate(
    float (&acc)[8][8], float* smem, const float* ag, int lda, int arows,
    const float* bg, int ldb, int brows, int depth, int kmax)
{
    constexpr int kStage = KSLICE * SPAD;
    float* as = smem;
    float* bs = smem + 2 * kStage;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

    const int ns = depth / KSLICE;
    load_operand<kAT, kMask>(as, ag, lda, arows, 0, kmax);
    load_operand<kBT, kMask>(bs, bg, ldb, brows, 0, kmax);
    cp_async_commit();
    for (int st = 0; st < ns; ++st) {
        if (st + 1 < ns) {
            const int nb = (st + 1) & 1;
            load_operand<kAT, kMask>(as + nb * kStage, ag, lda, arows,
                                     (st + 1) * KSLICE, kmax);
            load_operand<kBT, kMask>(bs + nb * kStage, bg, ldb, brows,
                                     (st + 1) * KSLICE, kmax);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* a = as + (st & 1) * kStage;
        const float* b = bs + (st & 1) * kStage;
#pragma unroll
        for (int kk = 0; kk < KSLICE; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(
                a + kk * SPAD + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(
                a + kk * SPAD + 64 + ty * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(
                b + kk * SPAD + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(
                b + kk * SPAD + 64 + tx * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// acc = A B^T on a 128x128 tile, A and B row-major with the depth index
// contiguous (element (r, m) at ag[r * lda + m]); rows >= arows, >= brows
// read as 0.  depth is a positive multiple of KSLICE.
__device__ __forceinline__ void tile_product(
    float (&acc)[8][8], float* smem, const float* ag, int lda, int arows,
    const float* bg, int ldb, int brows, int depth)
{
    tile_zero(acc);
    tile_accumulate<false, false, false>(acc, smem, ag, lda, arows, bg, ldb,
                                         brows, depth, 0);
}

// Writes s * acc (s = 1 or -1) to out (row pitch ld): rows < rows, columns
// < cols; float4 stores when vec (ld, the tile's column offset and cols
// multiples of 4).
__device__ __forceinline__ void tile_store(float* out, int ld, int rows,
                                           int cols, bool vec,
                                           const float (&acc)[8][8],
                                           float s)
{
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row_of(ty, i);
        if (r >= rows) continue;
        float* o = out + (size_t)r * ld;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = 64 * h + tx * 4;
            if (vec) {
                if (c < cols)
                    *reinterpret_cast<float4*>(o + c) = make_float4(
                        s * acc[i][4 * h], s * acc[i][4 * h + 1],
                        s * acc[i][4 * h + 2], s * acc[i][4 * h + 3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c + j < cols) o[c + j] = s * acc[i][4 * h + j];
            }
        }
    }
}

// ------------------------------------------------------ the diagonal tile
// The tile a and its inverse x are 4x4 blocks of 32x32 at pitch SPAD;
// blk(p, I, J) is block (I, J).  A warp works on one block at a time: lane
// r holds row r of one operand in registers.
__device__ __forceinline__ float* blk(float* p, int I, int J)
{
    return p + (I * kBlk) * SPAD + J * kBlk;
}

template <int P>
__device__ __forceinline__ void load_row(float (&v)[kBlk], const float* b,
                                         int r)
{
#pragma unroll
    for (int q = 0; q < kBlk / 4; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(b + r * P + 4 * q);
        v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
    }
}

template <int P>
__device__ __forceinline__ void store_row(float* b, int r,
                                          const float (&v)[kBlk])
{
#pragma unroll
    for (int q = 0; q < kBlk / 4; ++q)
        *reinterpret_cast<float4*>(b + r * P + 4 * q) = make_float4(
            v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// One warp, lane r: o[c] += sum_m A[r][m] B[c][m] (kNT) or
// sum_m A[r][m] B[m][c], A and B 32x32 at pitches PA and PB.  The lane
// reads its own row of A as float4 and B as float4 broadcasts, in a loop
// over four columns of A at a time: the kernels run once per tile step, so
// their code is fetched cold, and a short loop body is what keeps that
// cheap.
template <bool kNT, int PA, int PB>
__device__ __forceinline__ void warp_mm(float (&o)[kBlk], const float* a,
                                        const float* b)
{
    const int r = threadIdx.x & 31;
#pragma unroll 1
    for (int m = 0; m < kBlk; m += 4) {
        const float4 av = *reinterpret_cast<const float4*>(a + r * PA + m);
        const float v[4] = {av.x, av.y, av.z, av.w};
        if (kNT) {
#pragma unroll
            for (int c = 0; c < kBlk; ++c) {
                const float4 t = *reinterpret_cast<const float4*>(
                    b + c * PB + m);
                o[c] = fmaf(v[0], t.x, o[c]);
                o[c] = fmaf(v[1], t.y, o[c]);
                o[c] = fmaf(v[2], t.z, o[c]);
                o[c] = fmaf(v[3], t.w, o[c]);
            }
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int q = 0; q < kBlk / 4; ++q) {
                    const float4 t = *reinterpret_cast<const float4*>(
                        b + (m + u) * PB + 4 * q);
                    o[4 * q] = fmaf(v[u], t.x, o[4 * q]);
                    o[4 * q + 1] = fmaf(v[u], t.y, o[4 * q + 1]);
                    o[4 * q + 2] = fmaf(v[u], t.z, o[4 * q + 2]);
                    o[4 * q + 3] = fmaf(v[u], t.w, o[4 * q + 3]);
                }
        }
    }
}

// One warp: Y = L^{-1} for the lower-triangular 32x32 block at lb (pitch
// SPAD), into yb; rdiag[r] is the reciprocal of L[r][r] (Y's diagonal).
// Lane l computes column l: Y[r][l] = (delta_rl - sum_{m<r} L[r][m]
// Y[m][l]) rdiag[r], the sum in four interleaved parts, row r of L read
// as float4 broadcasts.  Reads only the lower triangle of lb.
__device__ __forceinline__ void invert_block(const float* lb, float* yb,
                                             const float* rdiag)
{
    const int l = threadIdx.x & 31;
    float y[kBlk];
#pragma unroll
    for (int r = 0; r < kBlk; ++r) {
        float s4[4] = {r == l ? 1.f : 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m4 = 0; m4 < (r + 3) / 4; ++m4) {
            const float4 t = *reinterpret_cast<const float4*>(
                lb + r * SPAD + 4 * m4);
            const float tm[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (4 * m4 + u < r) s4[u] -= tm[u] * y[4 * m4 + u];
        }
        y[r] = ((s4[0] + s4[1]) + (s4[2] + s4[3])) * rdiag[r];
    }
#pragma unroll
    for (int r = 0; r < kBlk; ++r) yb[r * SPAD + l] = y[r];
}

// One warp: factor diagonal block (s, s) of a (lower triangle read; lane l
// holds row l), then its inverse Y (with rsqrt(d2_r) as Y[r][r]).  Writes
// L (exact zeros above the diagonal) to a and Y to x.  Column j reaches
// the lanes through col (two 32-float buffers, alternating): each lane
// stores its A[l][j], and L[c][j] is read back as float4 broadcasts times
// the pivot's rsqrt, bit for bit the value lane c keeps.  The pivot is
// d2 * rsqrt(d2): a non-positive d2 gives NaN, never +-inf.
__device__ __forceinline__ void factor_block(float* a, float* x, float* col,
                                             int s)
{
    const int l = threadIdx.x & 31;
    float v[kBlk];
    float* lb = blk(a, s, s);
    load_row<SPAD>(v, lb, l);
    float myinv = 0.f;
#pragma unroll
    for (int j = 0; j < kBlk; ++j) {
        float* cj = col + (j & 1) * kBlk;
        cj[l] = v[j];
        __syncwarp();
        const float d2 = cj[j];
        const float inv = rsqrtf(d2);
        if (l == j) {
            v[j] = d2 * inv;
            myinv = inv;
        } else if (l > j) {
            v[j] *= inv;
        }
        const float lj = l > j ? v[j] : 0.f;
#pragma unroll
        for (int c4 = (j + 1) / 4; c4 < kBlk / 4; ++c4) {
            const float4 t = *reinterpret_cast<const float4*>(cj + 4 * c4);
            const float tc[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (4 * c4 + u > j) v[4 * c4 + u] -= lj * (tc[u] * inv);
        }
    }
#pragma unroll
    for (int j = 0; j < kBlk; ++j)
        if (j > l) v[j] = 0.f;
    store_row<SPAD>(lb, l, v);
    col[l] = myinv;   // buffer 0: its last readers (column 30) are past
    __syncwarp();     // column 31's barrier
    invert_block(lb, blk(x, s, s), col);
}

// (bi, bj), bj <= bi, of the t-th tile of a lower triangle in row order.
__device__ __forceinline__ void tri_decode(int t, int& bi, int& bj)
{
    int i = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    if ((i + 1) * (i + 2) / 2 <= t) ++i;
    if (i * (i + 1) / 2 > t) --i;
    bi = i;
    bj = t - i * (i + 1) / 2;
}

// The whole block: L of the 128x128 tile a (lower triangle read, SPD),
// right-looking over its four block columns with three barriers each;
// the diagonal blocks' inverses go to x.  col: 64 floats (warp 0).
__device__ __forceinline__ void factor_tile(float* a, float* x, float* col)
{
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    for (int s = 0; s < 4; ++s) {
        if (warp == 0) factor_block(a, x, col, s);
        __syncthreads();
        if (s == 3) break;
        if (warp < 3 - s) {   // L[I][s] = A[I][s] Y_s^T
            const int I = s + 1 + warp;
            float o[kBlk] = {};
            warp_mm<true, SPAD, SPAD>(o, blk(a, I, s), blk(x, s, s));
            __syncwarp();
            store_row<SPAD>(blk(a, I, s), l, o);
        }
        __syncthreads();
        if (warp < (3 - s) * (4 - s) / 2) {   // A[I][J] -= L[I][s] L[J][s]^T
            int I, J;
            tri_decode(warp, I, J);
            I += s + 1;
            J += s + 1;
            float o[kBlk] = {}, v[kBlk];
            warp_mm<true, SPAD, SPAD>(o, blk(a, I, s), blk(a, J, s));
            load_row<SPAD>(v, blk(a, I, J), l);
#pragma unroll
            for (int c = 0; c < kBlk; ++c) v[c] -= o[c];
            store_row<SPAD>(blk(a, I, J), l, v);
        }
        __syncthreads();
    }
}

// The whole block: x <- L^{-1} below its diagonal blocks (which hold the
// blocks' inverses on entry) by 2x2 block recursion, X_BA = -X_BB (L_BA
// X_AA): first for the pairs of blocks (0, 1) and (2, 3), then for the
// halves.  t: 4 x 32 x TT floats.  Reads the blocks of a below the
// diagonal blocks only.  Ends with a block barrier.
__device__ __forceinline__ void invert_tile(float* a, float* x, float* t)
{
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    if (warp < 2) {
        const int lo = 2 * warp;
        float* tb = t + warp * kBlk * TT;
        float o[kBlk] = {};
        warp_mm<false, SPAD, SPAD>(o, blk(a, lo + 1, lo), blk(x, lo, lo));
        store_row<TT>(tb, l, o);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < kBlk; ++c) o[c] = 0.f;
        warp_mm<false, SPAD, TT>(o, blk(x, lo + 1, lo + 1), tb);
#pragma unroll
        for (int c = 0; c < kBlk; ++c) o[c] = -o[c];
        store_row<SPAD>(blk(x, lo + 1, lo), l, o);
    }
    __syncthreads();
    if (warp < 4) {   // T[I][J] = sum_{J <= K < 2} L[I][K] X[K][J]
        const int I = 2 + (warp >> 1), J = warp & 1;
        float o[kBlk] = {};
        for (int K = J; K < 2; ++K)
            warp_mm<false, SPAD, SPAD>(o, blk(a, I, K), blk(x, K, J));
        store_row<TT>(t + warp * kBlk * TT, l, o);
    }
    __syncthreads();
    if (warp < 4) {   // X[I][J] = -sum_{2 <= K <= I} X[I][K] T[K][J]
        const int I = 2 + (warp >> 1), J = warp & 1;
        float o[kBlk] = {};
        for (int K = 2; K <= I; ++K)
            warp_mm<false, SPAD, TT>(o, blk(x, I, K),
                                     t + (2 * (K - 2) + J) * kBlk * TT);
#pragma unroll
        for (int c = 0; c < kBlk; ++c) o[c] = -o[c];
        store_row<SPAD>(blk(x, I, J), l, o);
    }
    __syncthreads();
}

// out[r] = (x v)[r] for r < nb, x the tile's L^{-1} and v 128 floats (both
// in shared memory): a warp per 16 rows, the lanes summed in a fixed
// order.  Adds log a[r][r] (L's diagonal) to lg and out[r]^2 to sq over
// the thread's rows r < nb (lane 0 of each warp).
__device__ __forceinline__ void tile_solve(const float* a, const float* x,
                                           const float* v, float* out,
                                           int nb, float& lg, float& sq)
{
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < CHOL_TILE / 8; ++i) {
        const int r = warp * (CHOL_TILE / 8) + i;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < CHOL_TILE / 32; ++j)
            s += x[r * SPAD + l + 32 * j] * v[l + 32 * j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (l == 0 && r < nb) {
            out[r] = s;
            sq += s * s;
            lg += logf(a[r * SPAD + r]);
        }
    }
}

// Shared-memory layout of a kernel that factors or inverts one 128x128
// tile: a [128][SPAD] (the tile, then L), x [128][SPAD] (L^{-1}),
// t [4][32][TT] (invert_tile's products), v [128] (a vector),
// col [4][2][32] (per-warp column buffers), red [NTHREADS / 32].
struct TileSmem {
    float *a, *x, *t, *v, *col, *red;
};

constexpr size_t kTileSmem = (2 * CHOL_TILE * SPAD + 4 * kBlk * TT
                              + CHOL_TILE + 8 * kBlk + NTHREADS / 32)
                             * sizeof(float);

__device__ __forceinline__ TileSmem tile_smem(float4* smem4)
{
    TileSmem s;
    s.a = reinterpret_cast<float*>(smem4);
    s.x = s.a + CHOL_TILE * SPAD;
    s.t = s.x + CHOL_TILE * SPAD;
    s.v = s.t + 4 * kBlk * TT;
    s.col = s.v + CHOL_TILE;
    s.red = s.col + 8 * kBlk;
    return s;
}

}  // namespace
