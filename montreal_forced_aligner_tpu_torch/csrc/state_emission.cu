// GMM emission log-likelihoods on demand, per graph state (K3), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _emission_kernel / pallas_state_loglikes of
// montreal_forced_aligner_tpu/ops/pallas_emission.py. The plain PyTorch
// version lives in ops/cuda_emission.py.
//
//   emit[b, t, s] = logsumexp_g ( [x, x*x, 1, 0...] . rows[pdf[b, s], g] )
//
// where x = feats[b, t] (Dfeat values) and rows (P, G, D2p) holds
// [means*invvars, -0.5*invvars, gconst, 0...] per Gaussian (ops/cuda_emission
// pack_rows; D2p = 2*Dfeat + 2 rounded up to a multiple of 4). Padded
// Gaussians carry gconst = -1e30 and vanish from the sum. The logsumexp
// streams a running max and a rescaled running sum over g, as the TPU
// kernel does, so nothing of size G is ever held per output.
//
// What bounds it on this card: arithmetic. Each output costs G * D2p
// multiply-adds (32 * 84 at SAT scale) against 4 bytes written, so the
// float32 rate of the CUDA cores (no tensor cores and no TF32 here) is the
// roofline; the per-pdf rows are re-read from L2 by every frame tile.
//
// What the design does about it: one block per (frame tile of 64, state
// tile of 64, batch row). The block loads its own pdf ids (the TPU's scalar
// prefetch) and builds [x, x*x, 1, 0] for its 64 frames once, in shared
// memory, transposed to (D2p, 64). For each Gaussian g it stages the 64
// states' rows transposed to (D2p, 64) in shared memory (both with a row
// stride of 65 words, so the transposing stores do not all hit one bank),
// and each of its 256
// threads computes a 4 x 4 register tile of q = xx . w with fp32 FMAs before
// the streaming max/sum update. States past S load pdf 0 and their outputs
// are not written; states whose pdf is 0 only because they pad the graph
// compute values the Viterbi never reaches.

#include <cuda_runtime.h>
#include <math.h>

#define NEG_INF (-1.0e30f)
#define T_TILE 64
#define S_TILE 64
#define THREADS 256
#define RT 4  // frames per thread
#define RS 4  // states per thread
#define XS (T_TILE + 1)  // shared-memory row strides, padded off the banks
#define WS (S_TILE + 1)

__global__ void __launch_bounds__(THREADS) state_emission_kernel(
    const float* __restrict__ feats,      // (B, T, Dfeat)
    const int* __restrict__ state_pdf,    // (B, S)
    const float* __restrict__ rows,       // (P, G, D2p)
    float* __restrict__ out,              // (B, T, S)
    int B, int T, int S, int Dfeat, int G, int D2p)
{
    extern __shared__ float smem[];
    float* xs = smem;             // (D2p, T_TILE), row stride XS
    float* ws = smem + D2p * XS;  // (D2p, S_TILE), row stride WS
    __shared__ int pdf_s[S_TILE];

    const int t0 = blockIdx.x * T_TILE;
    const int s0 = blockIdx.y * S_TILE;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int tx = tid % 16;  // state lane
    const int ty = tid / 16;  // frame lane

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
        xs[d * XS + tt] = v;
    }

    float m[RT][RS];
    float acc[RT][RS];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < RS; ++j) {
            m[i][j] = NEG_INF;
            acc[i][j] = 0.0f;
        }
    }

    for (int g = 0; g < G; ++g) {
        __syncthreads();  // pdf ids and xs ready; previous ws consumed
        for (int i = tid; i < S_TILE * D2p; i += THREADS) {
            const int ss = i / D2p;
            const int d = i - ss * D2p;
            ws[d * WS + ss] = rows[((size_t)pdf_s[ss] * G + g) * D2p + d];
        }
        __syncthreads();

        float q[RT][RS];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
            for (int j = 0; j < RS; ++j) q[i][j] = 0.0f;
        }
        for (int d = 0; d < D2p; ++d) {
            float xv[RT], wv[RS];
#pragma unroll
            for (int i = 0; i < RT; ++i) xv[i] = xs[d * XS + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < RS; ++j) wv[j] = ws[d * WS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
#pragma unroll
                for (int j = 0; j < RS; ++j) q[i][j] = fmaf(xv[i], wv[j], q[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
            for (int j = 0; j < RS; ++j) {
                const float mn = fmaxf(m[i][j], q[i][j]);
                acc[i][j] = acc[i][j] * expf(m[i][j] - mn) + expf(q[i][j] - mn);
                m[i][j] = mn;
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= T) continue;
#pragma unroll
        for (int j = 0; j < RS; ++j) {
            const int s = s0 + tx + 16 * j;
            if (s < S) out[((size_t)b * T + t) * S + s] = m[i][j] + logf(acc[i][j]);
        }
    }
}

extern "C" int state_emission(
    const float* feats, const int* state_pdf, const float* rows, float* out,
    int B, int T, int S, int Dfeat, int G, int D2p, void* stream)
{
    const size_t smem = (size_t)D2p * (XS + WS) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        state_emission_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + T_TILE - 1) / T_TILE, (S + S_TILE - 1) / S_TILE, B);
    state_emission_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        feats, state_pdf, rows, out, B, T, S, Dfeat, G, D2p);
    return (int)cudaGetLastError();
}
