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
// at bench widths, so the block's per-frame latency (one __syncthreads, the
// D-long compare chain and whatever each frame waits on) sets the time.
//
// What the design does about it: one block per batch row (the TPU's
// sequential grid over frame chunks becomes a loop over T inside the block);
// one thread per state (looping when S exceeds the block); alpha lives in
// shared memory, double-buffered, with NEG_INF halos of ub and lb slots so
// the shifted reads need no bounds checks, and one __syncthreads per frame.
// The kernel is templated on the seven (lb, ub) band buckets of
// ops/viterbi.py, so the slot scan unrolls fully and its loads issue
// together, and on where the band and alpha live (band_forward_plan picks
// the mode), so shared-memory reads compile to shared loads. Through (4, 16)
// (D <= 21), when every state has its own thread, each thread keeps its
// state's band column in registers, read once from the (B, S, D) band;
// through (2, 12) (D <= 15) it does so for two states, tid and tid + the
// block size, for graphs of up to 2048 states. Otherwise the band is staged
// in shared memory, transposed to (D, S) so neighbouring threads read
// neighbouring words, when it fits beside alpha, and else read from a
// (B, D, S) copy in global memory (L2). Emissions never stall the chain on
// device memory: each thread prefetches its own states' emissions RING - 1
// frames ahead with 4-byte cp.async into a ring of RING frames in shared
// memory (its own slots only, so the wait needs no barrier of its own);
// frame t reads them from there. Graphs too large for alpha and the ring in
// shared memory keep alpha in a global scratch row and read emissions
// directly. The loop stops at the row's own frame count instead of running
// the padded T. Only B blocks run, so at batch 32 the kernel occupies 32 of
// the 132 SMs.
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
// frames of emissions in the shared-memory ring (prefetch depth RING - 1)
#define RING 8
#define MAX_THREADS 1024
// widest band kept in registers with one state per thread (the (4, 16)
// bucket), and with two (the (2, 12) bucket)
#define MAX_REG_D1 21
#define MAX_REG_D2 15

// How band_forward lays out a row (band_forward_plan picks one):
enum {
    BAND_REGS = 0,   // band in registers; alpha and the ring in shared memory
    BAND_SMEM = 1,   // band, alpha and the ring in shared memory
    BAND_L2 = 2,     // band (B, D, S) in global memory; alpha, ring in shared
    ALL_GLOBAL = 3,  // alpha in global scratch, band (B, D, S) and emissions
                     // read from global memory: graphs too large for shared
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ring()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1));
}

// The best of the D slots into state s: ascending j, strict '>'.
template <int D>
__device__ __forceinline__ float slot_max(const float* ap, const float* w, int wstride,
                                          int& arg)
{
    float m = NEG_INF;
    arg = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
        const float c = __fadd_rn(ap[-j], w[j * wstride]);
        if (c > m) {
            m = c;
            arg = j;
        }
    }
    return m;
}

template <int LB, int UB, int MODE, int SPT>
__global__ void __launch_bounds__(MAX_THREADS) band_forward_kernel(
    const float* __restrict__ emit,   // (B, T, S)
    const float* __restrict__ band,   // (B, S, D); (B, D, S) for BAND_L2, ALL_GLOBAL
    const float* __restrict__ start,  // (B, S)
    const int* __restrict__ flens,    // (B,)
    float* __restrict__ alpha_T,      // (B, S)
    uint8_t* __restrict__ bp,         // (T, B, S); rows t < 1 or t >= flens unset
    float* __restrict__ alpha_glob,   // (B, 2, W) scratch for ALL_GLOBAL
    int B, int T, int S, float scale)
{
    constexpr int D = LB + UB + 1;
    constexpr bool REGS = MODE == BAND_REGS;
    constexpr bool SHARED = MODE != ALL_GLOBAL;  // alpha and the ring
    extern __shared__ __align__(16) float smem[];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int W = UB + S + LB;  // alpha row with its two halos

    // shared memory: [alpha (2, W)] [band (D, S) for BAND_SMEM] [ring (RING, S)]
    float* a0 = SHARED ? smem : alpha_glob + (size_t)b * 2 * W;
    float* a1 = a0 + W;
    float* band_s = smem + 2 * W;
    float* ring = smem + 2 * W + (MODE == BAND_SMEM ? D * S : 0);

    const float* band_row = band + (size_t)b * D * S;
    // REGS: thread tid holds states tid + i * nthr, i < SPT (clamped to
    // S - 1 for reads; only states < S are written)
    float breg[REGS ? SPT : 1][REGS ? D : 1];
    if constexpr (REGS) {
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
            const int s = tid + i * nthr;
#pragma unroll
            for (int j = 0; j < D; ++j)
                breg[i][j] = s < S ? band_row[(size_t)s * D + j] : NEG_INF;
        }
    } else if constexpr (MODE == BAND_SMEM) {
        for (int i = tid; i < D * S; i += nthr) {
            const int s = i / D;
            band_s[(i - s * D) * S + s] = band_row[i];
        }
    }
    // BAND_SMEM reads its staged (D, S) copy; BAND_L2, ALL_GLOBAL the (D, S) rows
    const float* bcols = MODE == BAND_SMEM ? band_s : band_row;

    for (int i = tid; i < W; i += nthr) {
        a0[i] = NEG_INF;
        a1[i] = NEG_INF;
    }
    __syncthreads();

    const float* em = emit + (size_t)b * T * S;
    for (int s = tid; s < S; s += nthr) {
        a0[UB + s] = __fadd_rn(start[(size_t)b * S + s], __fmul_rn(scale, em[s]));
    }
    const int L = min(flens[b], T);
    // prologue: frames 1 .. RING-1, one commit group each
    if constexpr (SHARED) {
        for (int t = 1; t < RING; ++t) {
            if (t < L) {
                for (int s = tid; s < S; s += nthr)
                    cp_async4(ring + (t % RING) * S + s, em + (size_t)t * S + s);
            }
            cp_async_commit();
        }
    }
    __syncthreads();

    float* prev = a0;
    float* cur = a1;
    for (int t = 1; t < L; ++t) {
        const float* et;
        if constexpr (SHARED) {
            // frame t + RING - 1 goes to the slot this thread read at t - 1,
            // before the last barrier; then frame t's group is complete
            const int tn = t + RING - 1;
            if (tn < L) {
                for (int s = tid; s < S; s += nthr)
                    cp_async4(ring + (tn % RING) * S + s, em + (size_t)tn * S + s);
            }
            cp_async_commit();
            cp_async_wait_ring();
            et = ring + (t % RING) * S;
        } else {
            et = em + (size_t)t * S;
        }
        uint8_t* bpt = bp + ((size_t)t * B + b) * S;
        // alpha[t-1, s - (j - lb)] = prev[ub + s - j + lb]
        if constexpr (REGS) {
            float m[SPT];
            int arg[SPT];
#pragma unroll
            for (int i = 0; i < SPT; ++i) {
                const int s = min(tid + i * nthr, S - 1);
                m[i] = slot_max<D>(prev + UB + LB + s, breg[i], 1, arg[i]);
            }
#pragma unroll
            for (int i = 0; i < SPT; ++i) {
                const int s = tid + i * nthr;
                if (s < S) {
                    cur[UB + s] = __fadd_rn(m[i], __fmul_rn(scale, et[s]));
                    bpt[s] = (uint8_t)arg[i];
                }
            }
        } else {
            for (int s = tid; s < S; s += nthr) {
                int arg;
                const float m = slot_max<D>(prev + UB + LB + s, bcols + s, S, arg);
                cur[UB + s] = __fadd_rn(m, __fmul_rn(scale, et[s]));
                bpt[s] = (uint8_t)arg;
            }
        }
        __syncthreads();
        float* tmp = prev;
        prev = cur;
        cur = tmp;
    }
    for (int s = tid; s < S; s += nthr) {
        alpha_T[(size_t)b * S + s] = prev[UB + s];
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

// How band_forward lays out a launch for these sizes: its block size, its
// mode (BAND_REGS ... ALL_GLOBAL) and states per thread in BAND_REGS, and
// the bytes of dynamic shared memory it uses (the return value).
extern "C" size_t band_forward_plan(int S, int lb, int ub, int* threads, int* mode,
                                    int* spt)
{
    const int D = lb + ub + 1;
    auto round32 = [](int n) { return n < 32 ? 32 : ((n + 31) / 32) * 32; };
    const size_t shared = (2 * (size_t)(ub + S + lb) + (size_t)RING * S) * sizeof(float);
    const size_t band_bytes = (size_t)D * S * sizeof(float);
    *threads = round32(S < MAX_THREADS ? S : MAX_THREADS);
    *spt = 1;
    if (shared > kMaxSmem) {
        *mode = ALL_GLOBAL;
        return 0;
    }
    if (D <= MAX_REG_D1 && S <= MAX_THREADS) {
        *mode = BAND_REGS;
    } else if (D <= MAX_REG_D2 && S <= 2 * MAX_THREADS) {
        *mode = BAND_REGS;
        *spt = 2;
        *threads = round32((S + 1) / 2);
    } else if (shared + band_bytes <= kMaxSmem) {
        *mode = BAND_SMEM;
        return shared + band_bytes;
    } else {
        *mode = BAND_L2;
    }
    return shared;
}

template <int LB, int UB, int MODE, int SPT>
static int launch_mode(
    const float* emit, const float* band, const float* start, const int* flens,
    float* alpha_T, uint8_t* bp, float* alpha_glob,
    int B, int T, int S, float scale, int threads, size_t smem, cudaStream_t stream)
{
    auto kernel = band_forward_kernel<LB, UB, MODE, SPT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<B, threads, smem, stream>>>(emit, band, start, flens, alpha_T, bp,
                                         alpha_glob, B, T, S, scale);
    return (int)cudaGetLastError();
}

template <int LB, int UB>
static int launch_bucket(
    const float* emit, const float* band, const float* start, const int* flens,
    float* alpha_T, uint8_t* bp, float* alpha_glob,
    int B, int T, int S, float scale, cudaStream_t stream)
{
    constexpr int D = LB + UB + 1;
    int threads = 0, mode = 0, spt = 0;
    const size_t smem = band_forward_plan(S, LB, UB, &threads, &mode, &spt);
#define LAUNCH(M, P)                                                            \
    return launch_mode<LB, UB, M, P>(emit, band, start, flens, alpha_T, bp,     \
                                     alpha_glob, B, T, S, scale, threads, smem, \
                                     stream)
    if constexpr (D <= MAX_REG_D1) {
        if (mode == BAND_REGS && spt == 1) LAUNCH(BAND_REGS, 1);
    }
    if constexpr (D <= MAX_REG_D2) {
        if (mode == BAND_REGS && spt == 2) LAUNCH(BAND_REGS, 2);
    }
    if (mode == BAND_SMEM) LAUNCH(BAND_SMEM, 1);
    if (mode == BAND_L2) LAUNCH(BAND_L2, 1);
    if (mode == ALL_GLOBAL) LAUNCH(ALL_GLOBAL, 1);
#undef LAUNCH
    return (int)cudaErrorInvalidValue;
}

// band is (B, S, D), or (B, D, S) where band_forward_plan says BAND_L2 or
// ALL_GLOBAL; alpha_glob is scratch for ALL_GLOBAL; (lb, ub) must be one of
// the seven buckets
extern "C" int band_forward(
    const float* emit, const float* band, const float* start, const int* flens,
    float* alpha_T, uint8_t* bp, float* alpha_glob,
    int B, int T, int S, int lb, int ub, float scale, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
#define BUCKET(L, U)                                                            \
    if (lb == L && ub == U)                                                     \
        return launch_bucket<L, U>(emit, band, start, flens, alpha_T, bp,       \
                                   alpha_glob, B, T, S, scale, st);
    BUCKET(1, 4)
    BUCKET(2, 8)
    BUCKET(2, 12)
    BUCKET(4, 16)
    BUCKET(8, 32)
    BUCKET(16, 64)
    BUCKET(16, 128)
#undef BUCKET
    return (int)cudaErrorInvalidValue;
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
