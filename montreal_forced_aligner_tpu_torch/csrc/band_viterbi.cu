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
// and holds the state otherwise. A state outside [0, S) reads slot 0, as the
// TPU kernel's one-hot select and the plain version do, so it moves by +lb a
// frame and may come back into range.
//
// What bounds K2 on this card: the chain. Each step's load address depends
// on the step before, so a row costs its frame count times one load-to-use
// latency plus the operations between loads; the bytes it needs (one per
// step, a state per frame out) are nothing. Read from bp in device memory,
// just written by K1 and mostly missing L2, a step costs hundreds of cycles;
// read from shared memory, tens. Staging frames to read one byte of each
// moves many bytes a step, though, through the one SM that walks the row, so
// the copy is the second bound: the design stages a window of each frame,
// and on the card the copy then keeps pace with the walk, neither far ahead.
//
// What the design does about it: one block per batch row, two warps. Warp 1
// copies the row's frames, last first, in chunks of BT_FRAMES frames into a
// ring of BT_STAGES chunks in shared memory, one TMA bulk copy per frame
// row, completing on the stage's "full" mbarrier; warp 0 walks a chunk once
// it is full and then frees its stage on the "empty" mbarrier, so the copies
// run up to three chunks ahead. A staged row holds WL = min(S, RB - 16)
// states from lo, where RB is the plan's power-of-two row size (at most
// 512): all of them (lo = 0) for graphs of up to RB - 16 states; else a
// window that the copier places from the state the walker last published
// (lo = that state - WL + 16, within [0, S - WL]), since real paths move a
// state or so a frame and downwards. Frame row t of row b starts at byte
// (t*B + b)*S of bp, 16-byte aligned only when S is a multiple of 16, so the
// copy takes the aligned 16-byte blocks that cover [lo, lo + WL); state s
// then sits at byte ((address of bp[t, b, lo]) & 15) + s - lo of the stage
// row. An aligned block that holds a byte of the tensor never crosses a
// page boundary, so the over-read is safe, and the bytes it brings from
// neighbouring rows, and from frames t = 0 and t >= flens that K1 never
// wrote, are never used. The walker keeps its state r relative to the stage
// row, so a step is three dependent instructions: the address
// (row | (r & (RB - 1)), rows RB-aligned), the byte load, and r + c - j, the
// frame's alignment shift and lb folded into c. It notes, off the chain,
// whether r left the staged states; if it did (the path left the window or
// [0, S), or the chunk is a short last one), it walks the chunk again step by
// step, reading such a step's byte from bp in device memory, or taking slot
// 0 outside [0, S). Lane k keeps the state of the chunk's k-th frame, and
// the warp stores a chunk's states with one coalesced store; frames t >=
// flens hold best[b] and are written by both warps before the walk.
// band_backtrace_plan (ops/cuda_viterbi.py) gives the row size and says
// which layout (whole rows or a window) a graph gets; both are this code.

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

// band_backtrace's chunk of frames (one per lane of the walking warp), the
// chunks in its ring, and its largest staged row
#define BT_FRAMES 32
#define BT_STAGES 4
#define BT_MAX_ROW 512
// states a window reaches above the state it was placed from
#define BT_UP 16

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

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes)
{
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity)
{
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const uint8_t* src, unsigned bytes,
                                          unsigned bar)
{
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ int lds_u8(unsigned addr)
{
    int v;
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
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

// One block of two warps per row b: warp 0 walks (its lanes in step), warp 1
// copies. Chunk c holds frames hi(c) = L-1 - c*BT_FRAMES down to
// max(hi(c) - BT_FRAMES + 1, 1), frame hi(c) - k in row k of stage
// c % BT_STAGES. The ring starts at the first RB-aligned byte of the
// dynamic shared memory.
__global__ void __launch_bounds__(64) band_backtrace_kernel(
    const uint8_t* __restrict__ bp,  // (T, B, S); rows t < 1 or t >= flens unread
    const int* __restrict__ flens,   // (B,)
    const int* __restrict__ best,    // (B,)
    int* __restrict__ states,        // (B, T)
    int B, int T, int S, int lb, int RB)
{
    extern __shared__ __align__(128) uint8_t bt_smem[];
    __shared__ __align__(8) uint64_t bars[2 * BT_STAGES];  // full, then empty
    __shared__ int lo_of[BT_STAGES];  // the first staged state of each stage
    __shared__ int published;         // the walker's state at its last chunk
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int start = best[b];
    // frames L-1 .. 1 are walked; frames L .. T-1 hold the start state
    const int L = max(min(flens[b], T), 1);
    int* out = states + (size_t)b * T;
    for (int t = L + tid; t < T; t += blockDim.x) out[t] = start;

    const int NC = (L - 1 + BT_FRAMES - 1) / BT_FRAMES;
    const int WL = min(S, RB - 16);
    const unsigned ring = (smem_addr(bt_smem) + RB - 1) & ~(unsigned)(RB - 1);
    const unsigned full = smem_addr(bars);
    const unsigned empty = full + 8 * BT_STAGES;
    if (tid == 0) {
        for (int s = 0; s < 2 * BT_STAGES; ++s) mbar_init(full + 8 * s);
        published = start;
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 1) {
        for (int c = 0; c < NC; ++c) {
            const int s = c % BT_STAGES;
            if (c >= BT_STAGES) mbar_wait(empty + 8 * s, (c / BT_STAGES - 1) & 1);
            const int hi = L - 1 - c * BT_FRAMES;
            // lane 0 reads the walker's state once and the warp takes its
            // window from there, so every lane stages the same states
            int lo = 0;
            if (lane == 0) {
                lo = max(0, min(*(volatile int*)&published - (WL - BT_UP), S - WL));
                lo_of[s] = lo;
            }
            lo = __shfl_sync(0xffffffffu, lo, 0);
            if (lane < min(BT_FRAMES, hi)) {
                const uint8_t* from = bp + ((size_t)(hi - lane) * B + b) * S + lo;
                const int o = (int)((uintptr_t)from & 15);
                const unsigned bytes = (unsigned)((o + WL + 15) >> 4) * 16;
                mbar_expect_tx(full + 8 * s, bytes);
                bulk_copy(ring + (unsigned)((s * BT_FRAMES + lane) * RB), from - o, bytes,
                          full + 8 * s);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(full + 8 * s);
        }
        return;
    }

    const unsigned mask = (unsigned)RB - 1;
    const unsigned frame_step = (unsigned)B * (unsigned)S;
    int state = start;
    for (int c = 0; c < NC; ++c) {
        const int s = c % BT_STAGES;
        if (lane == 0) *(volatile int*)&published = state;
        mbar_wait(full + 8 * s, (c / BT_STAGES) & 1);
        const int lo = lo_of[s];
        const int hi = L - 1 - c * BT_FRAMES;
        const int nf = min(BT_FRAMES, hi);
        const unsigned stage = ring + (unsigned)(s * BT_FRAMES * RB);
        // the low bits of the address of bp[hi, b, lo]; frame hi - k's is
        // k * frame_step lower
        const unsigned a0 = (unsigned)(uintptr_t)bp + (unsigned)lo
            + ((unsigned)hi * (unsigned)B + (unsigned)b) * (unsigned)S;
        const int entry = state;
        int mine = 0;  // lane k: the state at frame hi - k
        bool missed = nf < BT_FRAMES;
        if (!missed) {
            int o = (int)(a0 & 15);
            int r = state - lo + o;  // byte of the state in its stage row
#pragma unroll
            for (int k = 0; k < BT_FRAMES; ++k) {
                const int next_o = (int)((a0 - (unsigned)(k + 1) * frame_step) & 15);
                if (lane == k) mine = r - o + lo;
                missed |= (unsigned)(r - o) >= (unsigned)WL;
                const int j = lds_u8((stage + (unsigned)(k * RB)) | ((unsigned)r & mask));
                r += lb + next_o - o - j;
                o = next_o;
            }
            state = r - o + lo;
        }
        if (missed) {
            state = entry;
            for (int k = 0; k < nf; ++k) {
                if (lane == k) mine = state;
                const unsigned u = (unsigned)(state - lo);
                int j = 0;
                if (u < (unsigned)WL)
                    j = lds_u8(stage + (unsigned)(k * RB)
                               + ((a0 - (unsigned)k * frame_step) & 15) + u);
                else if ((unsigned)state < (unsigned)S)
                    j = bp[((size_t)(hi - k) * B + b) * S + state];
                state += lb - j;
            }
        }
        if (lane < nf) out[hi - lane] = mine;
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (lane == 0) out[0] = state;
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

// The launch takes band_backtrace_plan's (ops/cuda_viterbi.py) bytes a staged
// row (RB) and shared bytes. A row size this file cannot run (a window of
// fewer than BT_MAX_ROW - 16 states, or not a power of two) is refused, and
// so are shared bytes other than this file's ring, so the plan's chunk and
// ring sizes cannot drift from BT_FRAMES and BT_STAGES.
extern "C" int band_backtrace(
    const uint8_t* bp, const int* flens, const int* best, int* states,
    int B, int T, int S, int lb, int row_bytes, size_t smem, void* stream)
{
    const int RB = row_bytes;
    if (RB < 32 || RB > BT_MAX_ROW || (RB & (RB - 1)) != 0
        || (S > RB - 16 && RB != BT_MAX_ROW)
        || smem != (size_t)(BT_STAGES * BT_FRAMES + 1) * RB)
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        band_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    band_backtrace_kernel<<<B, 64, smem, (cudaStream_t)stream>>>(
        bp, flens, best, states, B, T, S, lb, RB);
    return (int)cudaGetLastError();
}
