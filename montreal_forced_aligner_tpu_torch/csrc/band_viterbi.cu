// Band-sparse Viterbi forward (K1) and backtrace (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernels of montreal_forced_aligner_tpu/ops/pallas_viterbi.py:
//   K1 band_forward   <- _band_forward_kernel / band_forward_pallas
//   K2 band_backtrace <- _band_backtrace_kernel / band_backtrace_pallas
// Plain PyTorch versions of both live in ops/cuda_viterbi.py; on the card the
// kernels must match them bit for bit.
//
// K1 computes, for each batch row b and frame t >= 1 while t < flens[b],
//   alpha[t, s] = max_j (alpha[t-1, s - (j - lb)] + band[b, j, s])
//                 + scale * emit[b, t, s]
// scanning the D = lb + ub + 1 offset slots in ascending j with a strict '>'
// (the first maximum wins), and writes the winning slot j as a u8
// backpointer. alpha[0] = start + scale * emit[:, 0]; rows freeze at
// flens[b], so alpha_T is the alpha of each row's last real frame.
//
// What bounds K1 on this card: the T-step dependency. Every frame needs the
// whole previous alpha row, so the frames of one row run in order inside one
// block; per frame the block reads S floats of emissions and writes S bytes
// of backpointers (about 5 bytes per state-frame in all) and does 2*D
// operations per state. Both are far below the card's memory and issue rates
// at bench widths, so the block's per-frame latency (one __syncthreads and a
// D-long compare chain per thread) sets the time.
//
// What the design does about it: one block per batch row (the TPU's
// sequential grid over frame chunks becomes a loop over T inside the block);
// one thread per state (looping when S exceeds the block); alpha lives in
// shared memory, double-buffered, with NEG_INF halos of ub and lb slots so
// the shifted reads need no bounds checks, and one __syncthreads per frame.
// The row's band is staged in shared memory (transposed to (D, S), so
// neighbouring threads read neighbouring words) when it fits beside alpha;
// otherwise it is read from global memory, where it stays in L2. Alpha itself
// falls back to a global scratch row for graphs too large for shared memory.
// The loop stops at the row's own frame count instead of running the padded
// T. Only B blocks run, so at batch 32 the kernel occupies 32 of the 132 SMs.
//
// Bit-identity with the plain version: m + scale*emit is two rounded
// operations (__fmul_rn / __fadd_rn, and the file is built with
// --fmad=false), NEG_INF is -1e30 and never -inf, the slot scan is ascending
// with a strict '>', and slots are numbered as in the plain version.
//
// K2 walks each row backwards from best[b]:
//   state[t-1] = state[t] - (bp[t, b, state[t]] - lb)  while 1 <= t < flens[b]
// and holds the state otherwise. It is a chain of T dependent one-byte loads
// per row, so load latency bounds it; one thread per row. A state outside
// [0, S) reads slot 0, as the TPU kernel's one-hot select and the plain
// version do.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1.0e30f)

// shared memory a block may use on sm_90 (227 KB)
static const size_t kMaxSmem = 232448;

__global__ void band_forward_kernel(
    const float* __restrict__ emit,   // (B, T, S)
    const float* __restrict__ band,   // (B, D, S)
    const float* __restrict__ start,  // (B, S)
    const int* __restrict__ flens,    // (B,)
    float* __restrict__ alpha_T,      // (B, S)
    uint8_t* __restrict__ bp,         // (T, B, S); rows t < 1 or t >= flens unset
    float* __restrict__ alpha_glob,   // (B, 2, W) scratch, or null
    int B, int T, int S, int lb, int ub, float scale,
    int band_in_smem)
{
    extern __shared__ float smem[];
    const int b = blockIdx.x;
    const int D = lb + ub + 1;
    const int W = ub + S + lb;  // alpha row with its two halos

    float* a0;
    float* band_s = smem;
    if (alpha_glob != nullptr) {
        a0 = alpha_glob + (size_t)b * 2 * W;
    } else {
        a0 = smem;
        band_s = smem + 2 * W;
    }
    float* a1 = a0 + W;

    const float* band_row = band + (size_t)b * D * S;
    const float* bsrc = band_row;
    if (band_in_smem) {
        for (int i = threadIdx.x; i < D * S; i += blockDim.x) band_s[i] = band_row[i];
        bsrc = band_s;
    }
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        a0[i] = NEG_INF;
        a1[i] = NEG_INF;
    }
    __syncthreads();

    const float* em = emit + (size_t)b * T * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        a0[ub + s] = __fadd_rn(start[(size_t)b * S + s], __fmul_rn(scale, em[s]));
    }
    __syncthreads();

    const int L = min(flens[b], T);
    float* prev = a0;
    float* cur = a1;
    for (int t = 1; t < L; ++t) {
        const float* et = em + (size_t)t * S;
        uint8_t* bpt = bp + ((size_t)t * B + b) * S;
        for (int s = threadIdx.x; s < S; s += blockDim.x) {
            // alpha[t-1, s - (j - lb)] = prev[ub + s - j + lb]
            const float* ap = prev + ub + lb + s;
            float m = NEG_INF;
            int arg = 0;
            for (int j = 0; j < D; ++j) {
                const float c = __fadd_rn(ap[-j], bsrc[(size_t)j * S + s]);
                if (c > m) {
                    m = c;
                    arg = j;
                }
            }
            cur[ub + s] = __fadd_rn(m, __fmul_rn(scale, et[s]));
            bpt[s] = (uint8_t)arg;
        }
        __syncthreads();
        float* tmp = prev;
        prev = cur;
        cur = tmp;
    }
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        alpha_T[(size_t)b * S + s] = prev[ub + s];
    }
}

__global__ void band_backtrace_kernel(
    const uint8_t* __restrict__ bp,  // (T, B, S)
    const int* __restrict__ flens,   // (B,)
    const int* __restrict__ best,    // (B,)
    int* __restrict__ states,        // (B, T)
    int B, int T, int S, int lb)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int state = best[b];
    const int L = flens[b];
    int* out = states + (size_t)b * T;
    for (int t = T - 1; t >= 1; --t) {
        out[t] = state;
        if (t < L) {
            const int j = (state >= 0 && state < S)
                ? bp[((size_t)t * B + b) * S + state] : 0;
            state = state - (j - lb);
        }
    }
    out[0] = state;
}

// Bytes of dynamic shared memory band_forward uses for these sizes, and
// where alpha and the band live: *alpha_in_smem / *band_in_smem.
extern "C" size_t band_forward_smem(int S, int lb, int ub, int* alpha_in_smem,
                                    int* band_in_smem)
{
    const size_t D = (size_t)(lb + ub + 1);
    const size_t alpha_bytes = 2 * (size_t)(ub + S + lb) * sizeof(float);
    const size_t band_bytes = D * (size_t)S * sizeof(float);
    *alpha_in_smem = alpha_bytes <= kMaxSmem;
    size_t used = *alpha_in_smem ? alpha_bytes : 0;
    *band_in_smem = used + band_bytes <= kMaxSmem;
    if (*band_in_smem) used += band_bytes;
    return used;
}

extern "C" int band_forward(
    const float* emit, const float* band, const float* start, const int* flens,
    float* alpha_T, uint8_t* bp, float* alpha_glob,
    int B, int T, int S, int lb, int ub, float scale, void* stream)
{
    int alpha_in_smem = 0, band_in_smem = 0;
    const size_t smem = band_forward_smem(S, lb, ub, &alpha_in_smem, &band_in_smem);
    cudaError_t err = cudaFuncSetAttribute(
        band_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int threads = ((S + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    band_forward_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        emit, band, start, flens, alpha_T, bp,
        alpha_in_smem ? nullptr : alpha_glob,
        B, T, S, lb, ub, scale, band_in_smem);
    return (int)cudaGetLastError();
}

extern "C" int band_backtrace(
    const uint8_t* bp, const int* flens, const int* best, int* states,
    int B, int T, int S, int lb, void* stream)
{
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    band_backtrace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        bp, flens, best, states, B, T, S, lb);
    return (int)cudaGetLastError();
}
