// Unit covariance of the marginal likelihood, for a batch of K lanes:
//   M[k, i, j] = mask_i && mask_j ? f(r2) + (i == j ? jitter : 0) : 0,
//   r2 = sum_d (a[k, i, d] - a[k, j, d])^2,  a = x / ls (length-scaled
// points, [K, N, D], D < 32), f the covariance's radial function.
// The covariance assembly of the port (core/likelihood.unit_cov_matrix).
//
// Replaces no Pallas kernel: in the JAX package this is a chain of
// element-wise operations (core/kernels.matern52 -> ard_sqdist ->
// _safe_sqrt, then the jitter and the mask) that XLA fuses into one loop.
// PyTorch runs that chain as about 20 separate element-wise kernels, each
// reading and writing a whole [K, N, N] buffer; this kernel writes each
// element of M once.
//
// Arithmetic: bit for bit that chain's, in float32.  r2 sums left to
// right over d (ard_sqdist's order below 32 dimensions); r = r2 > 0 ?
// sqrtf(r2) : 0 (_safe_sqrt); the constants are the float32 casts PyTorch
// makes of the chain's Python scalars; every add and multiply is a
// round-to-nearest intrinsic, so nvcc contracts none of them into an FMA
// that the chain's separate kernels do not make; sqrtf and expf without
// fast math.  Matern-5/2: ((1 + s5 r) + (5/3) r2) expf((-s5) r); Matern-3/2:
// (1 + s3 r) expf((-s3) r); squared-exponential: expf(-0.5 r2).
//
// What bounds it on an H100: the write of M, 4 K N^2 bytes (1.05 GB at
// [10, 5120, 5120], 0.31 ms at 3.35 TB/s).  It reads K N D floats and
// does about 30 flops, one sqrtf and one expf an element.
//
// Design: one block of 256 threads computes and stores a 64x64 output
// tile (bi, bj) of a lane, over the full square of tiles.  The tile's
// points are staged in shared memory, the columns' coordinates d-major so
// that a thread reads its 4 columns' as one float4.  Each thread computes
// 4 rows x 4 adjacent columns (16 sums of r2 in registers) and stores each
// row's 4 as one float4, 16 threads one contiguous 256-byte row segment; a
// row length that is not a multiple of 4, and the ragged edge, store
// element by element.  At [10, 5120, 5120] that is 64000 blocks, at
// [10, 512, 512] 640, over the card's 132 SMs.  The arithmetic, not the
// write, sets its time: 0.61 ms at [10, 5120, 5120] (Matern-5/2, H100
// 80GB HBM3).  r2 and M are exactly symmetric, so one triangle of tiles
// could be computed and each off-diagonal tile stored twice, through a
// transposed copy in shared memory: that read 0.39 ms, 0.2 ms less an
// evaluation, against B1's 16.5 ms, for about 40 more lines.
namespace {

constexpr int NTHREADS = 256;
constexpr int TS = 64;           // rows and columns of an output tile
constexpr int MAX_DIM = 31;      // the matmul form takes D >= 32
static_assert(TS * TS == 16 * NTHREADS, "4x4 outputs per thread");

// float32(math.sqrt(5.0)), float32(5.0 / 3.0), float32(math.sqrt(3.0))
constexpr float kSqrt5 = 0x1.1e377ap+1f;
constexpr float kFiveThirds = 0x1.aaaaaap+0f;
constexpr float kSqrt3 = 0x1.bb67aep+0f;

enum Kind { MATERN52 = 0, MATERN32 = 1, SQUARED_EXP = 2 };

__device__ __forceinline__ float safe_sqrt(float r2)
{
    return r2 > 0.f ? sqrtf(r2) : 0.f;
}

template <int KIND>
__device__ __forceinline__ float radial(float r2)
{
    if (KIND == MATERN52) {
        const float r = safe_sqrt(r2);
        const float p = __fadd_rn(__fadd_rn(1.f, __fmul_rn(kSqrt5, r)),
                                  __fmul_rn(kFiveThirds, r2));
        return __fmul_rn(p, expf(__fmul_rn(-kSqrt5, r)));
    } else if (KIND == MATERN32) {
        const float r = safe_sqrt(r2);
        return __fmul_rn(__fadd_rn(1.f, __fmul_rn(kSqrt3, r)),
                         expf(__fmul_rn(-kSqrt3, r)));
    } else {
        return expf(__fmul_rn(-0.5f, r2));
    }
}

// Columns j..j+3 of an output row of length n (those < n): one float4
// where the row's length and the edge allow it.
__device__ __forceinline__ void store4(float* row, int j, int n,
                                      const float (&v)[4])
{
    if ((n & 3) == 0 && j + 3 < n) {
        *reinterpret_cast<float4*>(row + j) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (j + q < n) row[j + q] = v[q];
    }
}

template <int KIND>
__global__ void __launch_bounds__(NTHREADS)
unit_cov_kernel(const float* __restrict__ a,
                const unsigned char* __restrict__ mask,
                float* __restrict__ m, int n, int d, float jitter)
{
    __shared__ __align__(16) float cpt[MAX_DIM * TS];   // [d][TS]
    __shared__ float rpt[TS * MAX_DIM];                 // [TS][d]
    __shared__ unsigned char cmask[TS], rmask[TS];
    const int bj = blockIdx.x, bi = blockIdx.y, lane = blockIdx.z;
    const int i0 = bi * TS, j0 = bj * TS;
    const int tid = threadIdx.x;
    const float* al = a + (size_t)lane * n * d;

    for (int e = tid; e < TS * d; e += NTHREADS) {
        const int c = e / d, dd = e - c * d;
        cpt[dd * TS + c] = j0 + c < n ? al[(size_t)j0 * d + e] : 0.f;
        rpt[e] = i0 + c < n ? al[(size_t)i0 * d + e] : 0.f;
    }
    if (tid < TS) {
        cmask[tid] = j0 + tid < n ? mask[j0 + tid] : 0;
        rmask[tid] = i0 + tid < n ? mask[i0 + tid] : 0;
    }
    __syncthreads();

    const int c4 = (tid & 15) * 4;     // the thread's first column in the tile
    const int r0 = tid >> 4;           // its rows r0, r0 + 16, r0 + 32, r0 + 48
    float r2[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) r2[p][q] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
        const float4 cv = *reinterpret_cast<const float4*>(&cpt[dd * TS + c4]);
        const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const float ai = rpt[(r0 + 16 * p) * d + dd];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float diff = __fsub_rn(ai, cj[q]);
                r2[p][q] = __fadd_rn(r2[p][q], __fmul_rn(diff, diff));
            }
        }
    }

    float* ml = m + (size_t)lane * n * n;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int r = r0 + 16 * p, i = i0 + r;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = j0 + c4 + q;
            const float k = radial<KIND>(r2[p][q]);
            v[q] = rmask[r] && cmask[c4 + q]
                       ? (i == j ? __fadd_rn(k, jitter) : k) : 0.f;
        }
        if (i < n) store4(ml + (size_t)i * n, j0 + c4, n, v);
    }
}

}  // namespace

// a: [K, n, d] float32, mask: [n] bytes (0 or 1), m: [K, n, n] float32,
// all contiguous on the device; kind: 0 Matern-5/2, 1 Matern-3/2,
// 2 squared-exponential.  Returns a cudaError_t (0: launched).
extern "C" int spm_unit_cov(const void* a, const void* mask, void* m, int K,
                            int n, int d, int kind, float jitter,
                            void* stream)
{
    const int nb = (n + TS - 1) / TS;
    if (K < 1 || K > 65535 || n < 1 || nb > 65535 || d < 1 || d > MAX_DIM)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* ap = static_cast<const float*>(a);
    const unsigned char* mp = static_cast<const unsigned char*>(mask);
    float* out = static_cast<float*>(m);
    const dim3 grid(nb, nb, K);
    switch (kind) {
    case MATERN52:
        unit_cov_kernel<MATERN52><<<grid, NTHREADS, 0, s>>>(ap, mp, out, n, d,
                                                            jitter);
        break;
    case MATERN32:
        unit_cov_kernel<MATERN32><<<grid, NTHREADS, 0, s>>>(ap, mp, out, n, d,
                                                            jitter);
        break;
    case SQUARED_EXP:
        unit_cov_kernel<SQUARED_EXP><<<grid, NTHREADS, 0, s>>>(ap, mp, out, n,
                                                               d, jitter);
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}
