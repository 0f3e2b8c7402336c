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
// Steps 2 and 3 share one device routine, tile_product: a 128x128 output
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
#include "tile_ops.cuh"   // NTHREADS, block_sum

#define CHOL_TILE 128     // diagonal and trailing tile width
#define CHOL_PANEL 256    // trailing depth; equal to gp_kernels.CHOL_PANEL
#define CHOL_SUB 32       // block of the diagonal tile; gp_kernels.CHOL_SUB
#define KSLICE 32         // depth of one staged operand slice
#define SPAD (CHOL_TILE + 4)   // pitch of staged operands and of the tile
#define TT (CHOL_SUB + 4)      // pitch of the inverse's 32x32 products

static_assert(NTHREADS == 256, "8x8 outputs per thread cover 128x128");
static_assert(CHOL_PANEL % CHOL_TILE == 0, "panel = whole tiles");
static_assert(CHOL_TILE == 4 * CHOL_SUB, "the tile is 4x4 blocks");

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlk = CHOL_SUB;   // 32: a warp's block
constexpr size_t kDiagSmem = (2 * CHOL_TILE * SPAD + 4 * kBlk * TT
                              + CHOL_TILE + 2 * kBlk + NTHREADS / 32)
                             * sizeof(float);
constexpr size_t kProdSmem = 4 * KSLICE * SPAD * sizeof(float);

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

// s[m][r] <- g[r * ld + k + m] for a 128-row x KSLICE slice of a row-major
// operand; rows >= nrows are zero-filled.  A warp copies 4 rows x 8
// columns (32-byte runs of each row); its stores hit 32 distinct banks
// because SPAD = 4 (mod 32).
__device__ __forceinline__ void load_slice(float* s, const float* g, int ld,
                                           int nrows, int k)
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
        cp_async4(s + (m + mm) * SPAD + r + 32 * h, src[h] + mm, ok[h]);
    }
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns tile rows row_of(ty, i) and
// columns row_of(tx, j) for i, j < 8: two runs of 4, 64 apart.
__device__ __forceinline__ int row_of(int t, int i)
{
    return (i < 4 ? 0 : 60) + t * 4 + i;
}

// acc[i][j] = sum_{m < depth} A(row_of(ty, i), m) * B(row_of(tx, j), m) on
// a 128x128 tile, A and B row-major (element (r, m) at ag[r * lda + m];
// rows >= arows, >= brows read as 0).  depth is a multiple of KSLICE.
// smem holds two stages of both operands (kProdSmem bytes).
__device__ __forceinline__ void tile_product(
    float (&acc)[8][8], float* smem, const float* ag, int lda, int arows,
    const float* bg, int ldb, int brows, int depth)
{
    constexpr int kStage = KSLICE * SPAD;
    float* as = smem;
    float* bs = smem + 2 * kStage;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    const int ns = depth / KSLICE;
    load_slice(as, ag, lda, arows, 0);
    load_slice(bs, bg, ldb, brows, 0);
    cp_async_commit();
    for (int st = 0; st < ns; ++st) {
        if (st + 1 < ns) {
            const int nb = (st + 1) & 1;
            load_slice(as + nb * kStage, ag, lda, arows, (st + 1) * KSLICE);
            load_slice(bs + nb * kStage, bg, ldb, brows, (st + 1) * KSLICE);
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
// over four columns of A at a time: the kernel runs once per tile step, so
// its code is fetched cold, and a short loop body is what keeps that cheap.
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

// One warp: factor diagonal block (s, s) of a (lower triangle read; lane l
// holds row l), then its inverse Y (lane l computes column l, with
// rsqrt(d2_r) as Y[r][r]).  Writes L (exact zeros above the diagonal) to
// a and Y to x.  Column j reaches the lanes through col (two 32-float
// buffers, alternating): each lane stores its A[l][j], and L[c][j] is
// read back as float4 broadcasts times the pivot's rsqrt, bit for bit the
// value lane c keeps.
__device__ __forceinline__ void factor_block(float* a, float* x, float* col,
                                             int s)
{
    const int l = threadIdx.x & 31;
    float v[kBlk], y[kBlk];
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
    // Y[r][l] = (delta_rl - sum_{m<r} L[r][m] Y[m][l]) rsqrt(d2_r), the sum
    // in four interleaved parts, row r of L read as float4 broadcasts
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
        y[r] = ((s4[0] + s4[1]) + (s4[2] + s4[3])) * col[r];
    }
    float* yb = blk(x, s, s);
#pragma unroll
    for (int r = 0; r < kBlk; ++r) yb[r * SPAD + l] = y[r];
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

__global__ void __launch_bounds__(NTHREADS, 1)
diag_kernel(float* __restrict__ ws, const float* __restrict__ dshift,
            float* __restrict__ w, float* __restrict__ linv,
            float* __restrict__ ld, float* __restrict__ q, int n, int s0)
{
    extern __shared__ float4 smem4[];
    float* a = reinterpret_cast<float*>(smem4);   // [128][SPAD]: tile, L
    float* x = a + CHOL_TILE * SPAD;              // [128][SPAD]: L^{-1}
    float* t = x + CHOL_TILE * SPAD;              // [4][32][TT]: products
    float* wk = t + 4 * kBlk * TT;                // [128]
    float* col = wk + CHOL_TILE;                  // [2][32]: factor_block
    float* red = col + 2 * kBlk;                  // [NTHREADS / 32]
    const int lane = blockIdx.x;
    const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
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

    // right-looking over the four block columns, three barriers each
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

    // L^{-1}, below the diagonal blocks: X_BA = -X_BB (L_BA X_AA), first for
    // the pairs of blocks (0, 1) and (2, 3), then for the halves
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

    // w_k <- L_kk^{-1} w_k, a warp per 16 rows (lanes summed in a fixed
    // order), then ld and q
    float lg = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < CHOL_TILE / 8; ++i) {
        const int r = warp * (CHOL_TILE / 8) + i;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < CHOL_TILE / 32; ++j)
            s += x[r * SPAD + l + 32 * j] * wk[l + 32 * j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (l == 0 && r < nb) {
            wl[s0 + r] = s;
            sq += s * s;
            lg += logf(a[r * SPAD + r]);
        }
    }
    lg = block_sum(lg, red);
    if (tid == 0) ld[lane] += lg;
    sq = block_sum(sq, red);
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
                                    (int)kDiagSmem))) return err;
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
            diag_kernel<<<K, NTHREADS, kDiagSmem, s>>>(W, D, V, X, LD, Q, n,
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
