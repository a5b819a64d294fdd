// GMM emission log-likelihoods on demand, per graph state (K3), for Hopper
// (sm_90a), on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel _emission_kernel / pallas_state_loglikes of
// montreal_forced_aligner_tpu/ops/pallas_emission.py. The plain PyTorch
// version lives in ops/cuda_emission.py.
//
//   emit[b, t, s] = logsumexp_g ( [x, x*x, 1, 0...] . rows[pdf[b, s], g] )
//
// where x = feats[b, t] (Dfeat values) and rows (P, G, D2p) holds
// [means*invvars, -0.5*invvars, gconst, 0...] per Gaussian (ops/cuda_emission
// pack_rows; D2p = 2*Dfeat + 2 rounded up to a multiple of 8, the depth of
// one mma step). Padded Gaussians carry gconst = -1e30 and vanish from the
// sum. The logsumexp streams a running max and a rescaled running sum over g,
// as the TPU kernel does, so nothing of size G is ever held per output.
//
// What bounds it on this card: arithmetic. Each output costs G * D2p
// multiply-adds (32 * 88 at SAT scale) against 4 bytes written. 3xTF32 does
// each product three times on the tensor cores, so its floor is three times
// the work at the 495 TFLOP/s TF32 rate; the per-pdf rows are re-read from
// L2 by every frame tile.
//
// Precision: one TF32 product (10-bit mantissa) misses the rtol 1e-5 /
// atol 1e-3 bar by far at SAT-scale magnitudes (x*x*invvar terms in the
// hundreds). Each operand a is split into a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), and q accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// in fp32 (mma.sync m16n8k8 tf32), which keeps about the fp32 product's
// error. The parameter rows are split once, at model load
// (ops/cuda_emission.split_rows), into the rows_split layout below; the
// features are split here, once per block.
//
// What the design does about it: one block per (128 frames, 64 states,
// batch row), 8 warps, each warp a 32 x 32 tile of outputs (2 m16 by 4 n8
// mma tiles). The block stages [x, x*x, 1, 0] for its frames once, split
// into hi and lo and stored in the mma A-fragment order, so each lane loads
// its fragment as one float4. For each Gaussian g the 64 states' rows (hi
// and lo) are gathered with 16-byte cp.async into a 2-stage shared-memory
// ring: the gather for g+1 is in flight while the products for g run. The
// rows_split layout puts each lane's B fragment [hi(k), hi(k+4), lo(k),
// lo(k+4)] in 16 contiguous bytes. The streaming max/sum update runs on the
// accumulator registers with one exp per output and Gaussian. States past S
// load pdf 0 and their outputs are not written; states whose pdf is 0 only
// because they pad the graph compute values the Viterbi never reaches.
// Features of dimension past 55 (D2p > 112) fall back to 64-frame blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG_INF (-1.0e30f)
#define S_TILE 64
#define WARPS_N 2  // warps along states, 32 states each
#define MT 2       // m16 tiles (frames) per warp
#define NT 4       // n8 tiles (states) per warp

// shared memory a block may use on sm_90 (227 KB)
static const size_t kMaxSmem = 232448;

__device__ __forceinline__ float tf32_rna(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats per ring row in shared memory: 2*D2p (a multiple of 16), plus 16
// when that is a multiple of 32, so rows n and n+1 of one 8-lane float4
// phase fall on the two halves of the banks.
__host__ __device__ inline int ring_stride(int D2p)
{
    const int row = 2 * D2p;
    return (row / 16) % 2 ? row : row + 16;
}

template <int WARPS_M>
__host__ __device__ constexpr int frames_per_block()
{
    return WARPS_M * MT * 16;
}

template <int WARPS_M>
static size_t smem_bytes(int D2p)
{
    return ((size_t)frames_per_block<WARPS_M>() * 2 * D2p
            + 2 * (size_t)S_TILE * ring_stride(D2p)) * sizeof(float);
}

template <int WARPS_M>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 1) state_emission_kernel(
    const float* __restrict__ feats,       // (B, T, Dfeat)
    const int* __restrict__ state_pdf,     // (B, S)
    const float* __restrict__ rows_split,  // (P, G, 2*D2p), split_rows order
    float* __restrict__ out,               // (B, T, S)
    int B, int T, int S, int Dfeat, int G, int D2p)
{
    constexpr int THREADS = WARPS_M * WARPS_N * 32;
    constexpr int T_TILE = frames_per_block<WARPS_M>();
    const int KS = D2p / 8;    // mma k-steps
    const int ROW = 2 * D2p;   // floats per (pdf, g) row in rows_split
    const int WSTR = ring_stride(D2p);

    extern __shared__ __align__(16) float smem[];
    // A fragments: [m-tile][k-step][lane][4], hi then lo
    float* xs_hi = smem;
    float* xs_lo = smem + T_TILE * D2p;
    float* ring = smem + 2 * T_TILE * D2p;  // [2][S_TILE][WSTR]
    __shared__ int pdf_s[S_TILE];

    const int t0 = blockIdx.x * T_TILE;
    const int s0 = blockIdx.y * S_TILE;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp % WARPS_M;  // frame group of 32
    const int wn = warp / WARPS_M;  // state group of 32
    const int gid = lane >> 2;
    const int tig = lane & 3;

    if (tid < S_TILE) {
        const int s = s0 + tid;
        pdf_s[tid] = s < S ? state_pdf[(size_t)b * S + s] : 0;
    }
    for (int i = tid; i < T_TILE * D2p; i += THREADS) {
        const int tt = i / D2p;
        const int d = i - tt * D2p;
        const int t = t0 + tt;
        float v = 0.0f;
        if (t < T) {
            const float* x = feats + ((size_t)b * T + t) * Dfeat;
            if (d < Dfeat) {
                v = x[d];
            } else if (d < 2 * Dfeat) {
                const float xv = x[d - Dfeat];
                v = xv * xv;
            } else if (d == 2 * Dfeat) {
                v = 1.0f;
            }
        }
        const float hi = tf32_rna(v);
        const float lo = tf32_rna(v - hi);
        // a0: (r, c), a1: (r + 8, c), a2: (r, c + 4), a3: (r + 8, c + 4)
        const int r = tt & 15, c = d & 7;
        const int at = (((tt >> 4) * KS + (d >> 3)) * 32 + (r & 7) * 4 + (c & 3)) * 4
                       + (r >> 3) + 2 * (c >> 2);
        xs_hi[at] = hi;
        xs_lo[at] = lo;
    }
    __syncthreads();  // pdf ids ready for the first gather

    const int chunks = ROW / 4;  // 16-byte copies per row
    auto gather = [&](int stage, int g) {
        float* dst = ring + stage * S_TILE * WSTR;
        for (int i = tid; i < S_TILE * chunks; i += THREADS) {
            const int ss = i / chunks;
            const int c = i - ss * chunks;
            cp_async16(dst + ss * WSTR + c * 4,
                       rows_split + ((size_t)pdf_s[ss] * G + g) * ROW + c * 4);
        }
        cp_async_commit();
    };

    float m[MT][NT][4];
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                m[i][j][e] = NEG_INF;
                acc[i][j][e] = 0.0f;
            }

    gather(0, 0);
    for (int g = 0; g < G; ++g) {
        // stage (g+1)&1 was last read at g-1, before that step's barrier
        if (g + 1 < G) {
            gather((g + 1) & 1, g + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // g's rows (and, at g = 0, the features) visible

        const float* ws = ring + (g & 1) * S_TILE * WSTR;
        float q[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) q[i][j][e] = 0.0f;

        for (int ks = 0; ks < KS; ++ks) {
            uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int at = (((wm * MT + i) * KS + ks) * 32 + lane) * 4;
                const float4 h = *reinterpret_cast<const float4*>(xs_hi + at);
                const float4 l = *reinterpret_cast<const float4*>(xs_lo + at);
                ahi[i][0] = __float_as_uint(h.x); ahi[i][1] = __float_as_uint(h.y);
                ahi[i][2] = __float_as_uint(h.z); ahi[i][3] = __float_as_uint(h.w);
                alo[i][0] = __float_as_uint(l.x); alo[i][1] = __float_as_uint(l.y);
                alo[i][2] = __float_as_uint(l.z); alo[i][3] = __float_as_uint(l.w);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                // [hi(k0+tig), hi(k0+tig+4), lo(k0+tig), lo(k0+tig+4)] of state n
                const float4 w = *reinterpret_cast<const float4*>(
                    ws + (wn * 32 + j * 8 + gid) * WSTR + ks * 16 + tig * 4);
                const uint32_t bh0 = __float_as_uint(w.x), bh1 = __float_as_uint(w.y);
                const uint32_t bl0 = __float_as_uint(w.z), bl1 = __float_as_uint(w.w);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    mma_tf32(q[i][j], alo[i], bh0, bh1);
                    mma_tf32(q[i][j], ahi[i], bl0, bl1);
                    mma_tf32(q[i][j], ahi[i], bh0, bh1);
                }
            }
        }

        // streaming logsumexp, one exp per output: the smaller of (m, q)
        // contributes exp(-|q - m|) relative to the larger
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float d = q[i][j][e] - m[i][j][e];
                    const float x = __expf(-fabsf(d));
                    if (d > 0.0f) {
                        acc[i][j][e] = fmaf(acc[i][j][e], x, 1.0f);
                        m[i][j][e] = q[i][j][e];
                    } else {
                        acc[i][j][e] += x;
                    }
                }
        __syncthreads();  // every warp is done with stage g&1
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int t = t0 + (wm * MT + i) * 16 + gid + 8 * (e >> 1);
            if (t >= T) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int s = s0 + wn * 32 + j * 8 + 2 * tig + (e & 1);
                if (s < S)
                    out[((size_t)b * T + t) * S + s] = m[i][j][e] + logf(acc[i][j][e]);
            }
        }
}

template <int WARPS_M>
static int launch(const float* feats, const int* state_pdf, const float* rows_split,
                  float* out, int B, int T, int S, int Dfeat, int G, int D2p,
                  cudaStream_t stream)
{
    const size_t smem = smem_bytes<WARPS_M>(D2p);
    cudaError_t err = cudaFuncSetAttribute(
        state_emission_kernel<WARPS_M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    constexpr int T_TILE = frames_per_block<WARPS_M>();
    dim3 grid((T + T_TILE - 1) / T_TILE, (S + S_TILE - 1) / S_TILE, B);
    state_emission_kernel<WARPS_M><<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(
        feats, state_pdf, rows_split, out, B, T, S, Dfeat, G, D2p);
    return (int)cudaGetLastError();
}

extern "C" int state_emission(
    const float* feats, const int* state_pdf, const float* rows_split, float* out,
    int B, int T, int S, int Dfeat, int G, int D2p, void* stream)
{
    if (D2p % 8 || D2p < 2 * Dfeat + 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (smem_bytes<4>(D2p) <= kMaxSmem)
        return launch<4>(feats, state_pdf, rows_split, out, B, T, S, Dfeat, G, D2p, st);
    if (smem_bytes<2>(D2p) <= kMaxSmem)
        return launch<2>(feats, state_pdf, rows_split, out, B, T, S, Dfeat, G, D2p, st);
    return (int)cudaErrorInvalidValue;
}
