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
// identity rows and add exactly 0 to ld and q.  With emit, ws leaves as L
// (lower; every tile above the diagonal tiles zeroed at the end, so L is a
// complete lower-triangular matrix) and w as L^{-1} r; without emit ws is
// scratch.
//
// What bounds it on an H100: the O(N^3/3) flops of the trailing updates,
// in f32 on the CUDA cores (TF32 tensor cores are excluded on purpose: the
// sampler and posterior need full f32), 67 TFLOP/s at the SXM part's
// 700 W.  Each panel step also reads and writes the lower trailing
// triangle once (C), about N^3/(3 CHOL_PANEL) floats a lane.  Behind the
// trailing updates sits the serial chain of N pivots, paid CHOL_TILE at a
// time by one block per lane (diag_kernel, then panel_kernel).
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
//   2. panel_kernel     L_ik = A_ik L_kk^{-T} (tile_ops.cuh's tile_product)
//                       and w_i -= L_ik w_k, one block per 128-row tile
//                       below; it writes L_ik^T into the strip above the
//                       panel (rows k, columns i: scratch until then), and
//                       L_ik itself only with emit, since nothing reads it
//                       again;
//   3. trailing_kernel  A_ij -= L_ik L_jk^T on the lower 128x128 tiles,
//                       persistent (below).  A panel wider than CHOL_TILE is
//                       factored CHOL_TILE columns at a time, each step
//                       first updating the panel's next columns (the
//                       same kernel, `narrow`).
//
// The trailing update (trailing_kernel), and what bounds it.  Measured on
// the per-panel kernel it replaces (one 128x128 tile a block over a
// triangular grid, tile_product with 4-byte transposing copies, clock64
// stamps at [10, 5120, 5120]): 14% of a tile's block time waited for its
// first slice, 27% in its read-modify-write of C, 59% in the product, which
// ran at the FFMA rate of an SM shared by two blocks.  Alone on the card
// the product's loop reaches 79% of the FFMA peak; with those transposing
// copies feeding it, 62%; with 16-byte copies of depth-major operands, 79%
// again.  So:
//   - operands are read from the strip (L^T, written by the panel step):
//     a slice is kTK = 16 rows of 128 contiguous floats, copied by
//     16-byte cp.async straight into depth-major shared memory (pitch 128,
//     no transposition, no bank conflicts); a ring of kRing = 3 slices, one
//     block barrier a slice;
//   - a fixed grid of every SM's resident blocks (2 an SM: 256 threads, 128
//     registers, 112 KB of shared memory each), read from the device at its
//     first call, walks a static list of work items (tile t of lane l at
//     t + l per_lane; items b, b + grid, ... for block b), shrunk to the
//     items where they are fewer; the load cursor runs kRing - 1 slices
//     ahead across items, so the next item's first slices are in flight
//     while this one finishes;
//   - the item's C arrives in shared memory (64 KB, a quarter with each of
//     its first four slices), so the epilogue is a shared-memory read, the
//     subtraction and a 16-byte store;
//   - on a diagonal tile the two warps whose 32x64 lie above the diagonal
//     (nothing reads them) skip the products;
//   - 8x8 outputs a thread as four 4x4 runs: rows 32 wr + 4 lr (+16),
//     columns 64 wc + 4 lc (+32) for warp 2 wr + wc, lane 8 lr + lc.  More
//     outputs a thread would need more than the 128 registers that two
//     blocks an SM leave (and one block of 8 warps an SM reached half the
//     FFMA rate), a wider tile more shared memory than the ring and C take.
// Each element's sum is fmaf over the depth in increasing order from 0.f,
// subtracted from C once per panel, as the per-panel kernel did: L, w, ld
// and q are its bits.  ws starts as M only in the first panel's columns;
// the first panel's trailing update reads the rest of C from M itself.
//
// A ragged edge (N not a multiple of 128) is masked inside the kernels: the
// last diagonal tile is padded with identity in shared memory and the
// copies zero-fill rows past N; N % 4 != 0 takes 4-byte copies and stores.
// Kernels never allocate and never synchronise; the caller's stream orders
// the launches.  ld and q are accumulated by one block per lane in launch
// order and no sum depends on the schedule, so every output is
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
        if (!emit) continue;   // only the strip's copy is read again
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
    // L_ik^T into the strip above (rows s0.., columns r0..), where the
    // trailing update reads its operands depth-major: transposed in shared
    // memory (free since tile_product's last barrier), then written out a
    // whole 512-byte row a warp
    float* st = reinterpret_cast<float*>(smem4);   // [128][SPAD]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float4*>(st + row_of(tx, j) * SPAD + 64 * h
                                       + ty * 4) = make_float4(
                acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j],
                acc[4 * h + 3][j]);
    __syncthreads();
    if (vec) {   // then rows % 4 == 0
#pragma unroll
        for (int it = 0; it < CHOL_TILE * CHOL_TILE / 4 / NTHREADS; ++it) {
            const int e = it * NTHREADS + tid;
            const int c = e >> 5, r = (e & 31) * 4;
            if (r < rows)
                *reinterpret_cast<float4*>(A + (size_t)(s0 + c) * n + r0 + r)
                    = *reinterpret_cast<const float4*>(st + c * SPAD + r);
        }
    } else {
        for (int e = tid; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
            const int c = e >> 7, r = e & (CHOL_TILE - 1);
            if (r < rows) A[(size_t)(s0 + c) * n + r0 + r] = st[c * SPAD + r];
        }
    }
}

// ------------------------------------------------------ trailing update
// One launch's work: A_ij -= L_ik L_jk^T over k in [k0, k0 + depth), on
// the 128x128 tiles at rows and columns t0 + 128 (bi, bj) of every lane:
// the lower triangle of them (per_lane = m (m + 1) / 2), or with `narrow`
// only the column bj = 0 (per_lane = m: the rest of a panel wider than
// CHOL_TILE).  Work item it is tile it % per_lane of lane it / per_lane.  C is read at ws + src_off (the
// input M, where the workspace holds no copy of it yet) and written to ws.
// L_ik is read from the strip above, where panel_kernel left L^T: row k
// holds L_ik for every i, so an operand slice is kTK rows of contiguous
// floats.
struct TrailWork {
    long long src_off;
    int n, k0, depth, t0, narrow, per_lane, items;
};

constexpr int kTK = 16;     // depth of one slice of the ring
constexpr int kRing = 3;    // slices in the ring
constexpr int kSlice = kTK * CHOL_TILE;   // floats of one operand's slice
// the ring (both operands), then the C tile (pitch CHOL_TILE)
constexpr size_t kTrailSmem = (kRing * 2 * kSlice + CHOL_TILE * CHOL_TILE)
                              * sizeof(float);
// an item's C rides, a quarter at a time, with the copies issued at its
// first four slices: the last quarter, in the group of slice 3 + kRing - 1,
// has landed by the item's last slice (the narrow update has CHOL_TILE /
// kTK slices)
constexpr int kCParts = 4;
static_assert(kCParts - 1 + kRing - 1 <= CHOL_TILE / kTK - 1,
              "C must land within the item");
static_assert(kSlice / 4 == 2 * NTHREADS,
              "two 16-byte copies a thread of each operand's slice");

struct TrailTile {
    float* c;          // the tile's first element
    const float* a;    // L_ik^T: strip row k0, column i0
    const float* b;    // L_jk^T: strip row k0, column j0
    int rows, cols;
    bool diag;         // a diagonal tile: its upper right quarter unread
};

__device__ __forceinline__ TrailTile trail_tile(float* ws, const TrailWork& w,
                                                int it)
{
    const int lane = it / w.per_lane;
    const int t = it - lane * w.per_lane;
    int bi = t, bj = 0;
    if (!w.narrow) tri_decode(t, bi, bj);
    const int i0 = w.t0 + bi * CHOL_TILE, j0 = w.t0 + bj * CHOL_TILE;
    float* A = ws + (size_t)lane * w.n * w.n;
    TrailTile tt;
    tt.c = A + (size_t)i0 * w.n + j0;
    tt.a = A + (size_t)w.k0 * w.n + i0;
    tt.b = A + (size_t)w.k0 * w.n + j0;
    tt.rows = min(CHOL_TILE, w.n - i0);
    tt.cols = min(CHOL_TILE, w.n - j0);
    tt.diag = bi == bj;
    return tt;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// s[m][r] <- g[m * n + r], m < kTK, r < 128 (g: a strip row and the
// operand tile's first column), by 4-byte copies (n % 4 != 0); columns
// r >= nrows zero-filled.
__device__ __forceinline__ void load_trail(float* s, const float* g, int n,
                                           int nrows)
{
    for (int it = 0; it < kSlice / NTHREADS; ++it) {
        const int e = it * NTHREADS + threadIdx.x;
        const int m = e >> 7, r = e & (CHOL_TILE - 1);
        cp_async4(s + m * CHOL_TILE + r,
                  r < nrows ? g + (size_t)m * n + r : g, r < nrows);
    }
}

// Quarter q of the tile's C (rows 32 q + [0, 32)), read at c, into
// cs[r][c] (pitch CHOL_TILE), rows < rows and columns < cols (the epilogue
// reads no other); 16-byte copies where n % 4 == 0.
__device__ __forceinline__ void load_c(float* cs, const float* c, int rows,
                                       int cols, int n, int q)
{
    constexpr int kRows = CHOL_TILE / kCParts;
    if ((n & 3) == 0) {
#pragma unroll
        for (int it = 0; it < kRows * CHOL_TILE / 4 / NTHREADS; ++it) {
            const int e = it * NTHREADS + threadIdx.x;
            const int r = q * kRows + (e >> 5), cc = (e & 31) * 4;
            if (r < rows && cc < cols)
                cp_async16(cs + r * CHOL_TILE + cc, c + (size_t)r * n + cc,
                           true);
        }
    } else {
        for (int it = 0; it < kRows * CHOL_TILE / NTHREADS; ++it) {
            const int e = it * NTHREADS + threadIdx.x;
            const int r = q * kRows + (e >> 7), cc = e & (CHOL_TILE - 1);
            if (r < rows && cc < cols)
                cp_async4(cs + r * CHOL_TILE + cc, c + (size_t)r * n + cc,
                          true);
        }
    }
}

// Thread tid = 32 (2 wr + wc) + 8 lr + lc owns C's rows 32 wr + 4 lr and
// 16 more, columns 64 wc + 4 lc and 32 more (four runs of 4): a warp's
// 32 x 64 reads 4 distinct float4 of one operand and 8 of the other.
__global__ void __launch_bounds__(NTHREADS, 2)
trailing_kernel(float* __restrict__ ws, const TrailWork w)
{
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    float* csm = ring + kRing * 2 * kSlice;
    const int ns = w.depth / kTK;
    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int r0 = (warp >> 1) * 32 + (l >> 3) * 4;
    const int c0 = (warp & 1) * 64 + (l & 7) * 4;
    constexpr int rs = 16, cs = 32;

    // The load cursor runs kRing - 1 slices ahead of the compute, across
    // work items: item l_it, slice l_st, into ring stage l_slot.  Where
    // n % 4 == 0 a thread copies, of each operand's slice, depths m0 and
    // m0 + 8 at columns lr .. lr + 3: its two source pointers are all the
    // cursor keeps of an item.
    const bool vec = (w.n & 3) == 0;
    const int m0 = threadIdx.x >> 5, lr = (threadIdx.x & 31) * 4;
    int l_it = blockIdx.x, l_st = 0, l_slot = 0;
    const float *pa = nullptr, *pb = nullptr;
    bool va = false, vb = false;
    auto aim = [&]() {
        if (l_it >= w.items || !vec) return;
        const TrailTile t = trail_tile(ws, w, l_it);
        va = lr < t.rows;
        vb = lr < t.cols;
        pa = va ? t.a + (size_t)m0 * w.n + lr : t.a;
        pb = vb ? t.b + (size_t)m0 * w.n + lr : t.b;
    };
    aim();
    auto issue = [&]() {
        if (l_it < w.items) {
            float* s = ring + l_slot * 2 * kSlice;
            if (vec) {
                const size_t off = (size_t)l_st * kTK * w.n;
                const size_t off8 = off + (size_t)8 * w.n;
                float* d = s + m0 * CHOL_TILE + lr;
                cp_async16(d, va ? pa + off : pa, va);
                cp_async16(d + 8 * CHOL_TILE, va ? pa + off8 : pa, va);
                cp_async16(d + kSlice, vb ? pb + off : pb, vb);
                cp_async16(d + kSlice + 8 * CHOL_TILE, vb ? pb + off8 : pb,
                           vb);
            } else {
                const TrailTile t = trail_tile(ws, w, l_it);
                const size_t off = (size_t)l_st * kTK * w.n;
                load_trail(s, t.a + off, w.n, t.rows);
                load_trail(s + kSlice, t.b + off, w.n, t.cols);
            }
            if (++l_st == ns) {
                l_st = 0;
                l_it += gridDim.x;
                aim();
            }
        }
        cp_async_commit();
        l_slot = l_slot + 1 == kRing ? 0 : l_slot + 1;
    };
#pragma unroll
    for (int s = 0; s < kRing - 1; ++s) issue();

    int c_slot = 0;
    for (int it = blockIdx.x; it < w.items; it += gridDim.x) {
        const TrailTile ct = trail_tile(ws, w, it);
        // on a diagonal tile the warps of rows 0-63, columns 64-127 own
        // only elements above the diagonal, which nothing reads
        const bool idle = ct.diag && (warp & 1) && warp < 4;
        float acc[8][8];
        tile_zero(acc);
        for (int st = 0; st < ns; ++st) {
            cp_async_wait<kRing - 2>();
            __syncthreads();
            // every thread is past the last epilogue: C may be refilled
            if (st < kCParts)
                load_c(csm, ct.c + w.src_off, ct.rows, ct.cols, w.n, st);
            issue();
            const float* a = ring + c_slot * 2 * kSlice;
            const float* b = a + kSlice;
            c_slot = c_slot + 1 == kRing ? 0 : c_slot + 1;
            if (idle) continue;
#pragma unroll
            for (int kk = 0; kk < kTK; ++kk) {
                const float4 a0 = *reinterpret_cast<const float4*>(
                    a + kk * CHOL_TILE + r0);
                const float4 a1 = *reinterpret_cast<const float4*>(
                    a + kk * CHOL_TILE + rs + r0);
                const float4 b0 = *reinterpret_cast<const float4*>(
                    b + kk * CHOL_TILE + c0);
                const float4 b1 = *reinterpret_cast<const float4*>(
                    b + kk * CHOL_TILE + cs + c0);
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
        }

        // C -= acc, the result straight to device memory (vec: cols % 4
        // == 0 too)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = r0 + (i >> 2) * rs + (i & 3);
            if (r >= ct.rows) continue;
            float* o = ct.c + (size_t)r * w.n;
            const float* v = csm + r * CHOL_TILE;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = c0 + h * cs;
                if (vec) {
                    if (c < ct.cols) {
                        float4 u = *reinterpret_cast<const float4*>(v + c);
                        u.x -= acc[i][4 * h];
                        u.y -= acc[i][4 * h + 1];
                        u.z -= acc[i][4 * h + 2];
                        u.w -= acc[i][4 * h + 3];
                        *reinterpret_cast<float4*>(o + c) = u;
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (c + j < ct.cols)
                            o[c + j] = v[c + j] - acc[i][4 * h + j];
                }
            }
        }
    }
    cp_async_wait<0>();
}

// With emit: ws's tiles above the diagonal tiles, where the strips carried
// L^T, <- 0.  Block t zeroes strict upper tile t of a lane.
__global__ void __launch_bounds__(NTHREADS)
upper_zero_kernel(float* __restrict__ ws, int n)
{
    int a, bi;
    tri_decode(blockIdx.x, a, bi);   // bi <= a
    const int r0 = bi * CHOL_TILE, c0 = (a + 1) * CHOL_TILE;
    const int rows = min(CHOL_TILE, n - r0), cols = min(CHOL_TILE, n - c0);
    float* t = ws + (size_t)blockIdx.y * n * n + (size_t)r0 * n + c0;
    if ((n & 3) == 0) {
#pragma unroll
        for (int it = 0; it < CHOL_TILE * CHOL_TILE / 4 / NTHREADS; ++it) {
            const int e = it * NTHREADS + threadIdx.x;
            const int r = e >> 5, c = (e & 31) * 4;
            if (r < rows && c < cols)
                *reinterpret_cast<float4*>(t + (size_t)r * n + c) =
                    make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int e = threadIdx.x; e < CHOL_TILE * CHOL_TILE; e += NTHREADS) {
            const int r = e >> 7, c = e & (CHOL_TILE - 1);
            if (r < rows && c < cols) t[(size_t)r * n + c] = 0.f;
        }
    }
}

}  // namespace

// The persistent grid holds every block the card keeps resident: its SMs
// times the blocks of trailing_kernel that fit on one, read from the
// device at its first call.
static int g_slots[64];

static cudaError_t trailing_setup()
{
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(
             trailing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)kTrailSmem))) return err;
    if ((err = cudaFuncSetAttribute(
             trailing_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared))) return err;
    int dev;
    if ((err = cudaGetDevice(&dev))) return err;
    if (dev < 64 && g_slots[dev] == 0) {
        int sms = 0, per = 0;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev))) return err;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per, trailing_kernel, NTHREADS, kTrailSmem))) return err;
        g_slots[dev] = sms * (per > 0 ? per : 1);
    }
    return cudaSuccess;
}

// One launch of the trailing update (TrailWork) on the persistent grid,
// shrunk to the work items where they are fewer; C read at src.
static void trailing(float* W, const float* src, int K, int n, int k0,
                     int depth, int t0, int narrow, cudaStream_t s)
{
    int dev = 0;
    cudaGetDevice(&dev);
    const int slots = dev < 64 && g_slots[dev] ? g_slots[dev] : 264;
    const int m = (n - t0 + CHOL_TILE - 1) / CHOL_TILE;
    TrailWork w;
    w.src_off = src - W;
    w.n = n; w.k0 = k0; w.depth = depth; w.t0 = t0; w.narrow = narrow;
    w.per_lane = narrow ? m : m * (m + 1) / 2;
    w.items = K * w.per_lane;
    trailing_kernel<<<min(w.items, slots), NTHREADS, kTrailSmem, s>>>(W, w);
}

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
    cudaError_t err;
    if ((err = cudaFuncSetAttribute(diag_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kTileSmem))) return err;
    if ((err = cudaFuncSetAttribute(panel_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kProdSmem))) return err;
    if ((err = trailing_setup())) return err;
    // ws starts as M only in the first panel's columns, which the panel
    // steps read there; every other tile's first read is the first trailing
    // update's, which reads M itself
    if ((err = cudaMemcpy2DAsync(ws, n * sizeof(float), m0, n * sizeof(float),
                                 min(CHOL_PANEL, n) * sizeof(float),
                                 (size_t)K * n, cudaMemcpyDeviceToDevice,
                                 s))) return err;
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
    const float* M = static_cast<const float*>(m0);
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
                    trailing(W, W, K, n, s0, CHOL_TILE, s1, 1, s);
            }
            if ((err = cudaGetLastError())) return err;
        }
        if (k1 >= n) break;
        // the first update of the region beyond the first panel reads M
        trailing(W, k0 == 0 ? M : W, K, n, k0, k1 - k0, k1, 0, s);
        if ((err = cudaGetLastError())) return err;
    }
    const int nt = (n + CHOL_TILE - 1) / CHOL_TILE;
    if (emit && nt > 1)
        upper_zero_kernel<<<dim3(nt * (nt - 1) / 2, K), NTHREADS, 0, s>>>(W, n);
    return cudaGetLastError();
}
