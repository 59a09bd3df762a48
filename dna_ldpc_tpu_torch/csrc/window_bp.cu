// Sum-product BP of one SC-LDPC window (ops/scldpc.py's sliding-window and
// pipeline decoders), every iteration of the window in one launch.
//
// It replaces no Pallas kernel: the JAX package runs a window's BP as XLA
// (dna_ldpc_tpu/ops/bp.py, the generic gather decoder), and the port first
// ran it as ~40 eager torch ops an iteration over [B, edges] tensors with
// int64 indices (ops/bp.py::bp_decode_generic), plus one host read an
// iteration for the early stop. A window graph is small (lifting 256, W = 6:
// 4,608 checks, 12,288 variables, 27,648 edges), so one frame's whole state
// fits in one block's shared memory, and nothing of it needs device memory
// between iterations.
//
// One thread block per frame, for the whole window. Shared memory holds the
// float32 check-to-variable message of every check slot (slot-major,
// [dc][M], so that the threads of a warp touch consecutive words), the
// float32 posterior and the channel LLRs: 4 (dc M + 2 N) bytes, 209 KB at
// lifting 256 of the 227 KB a block may use. The graph's tables come from
// device memory as uint16, shared by all blocks through L2: each check's
// variables ([dc][M]) and each variable's message slots ([dv][N], the index
// k M + c of its slot, in the graph's table order); 0xFFFF marks a pad.
//
// Per iteration n, exactly ops/bp.py::_iterate with _check_messages and
// _posterior_update, in float32 (built without fast-math: tanhf, logf,
// expf and log1pf are the libdevice routines torch's CUDA ops call):
//   1. one thread per check reads its variables' posteriors and takes the
//      parity of the current decisions (n = 0: LLR < 0; later:
//      !(posterior > 0)); __syncthreads_or gives the frame's syndrome. At
//      the first zero syndrome the frame latches its bits, iterations (n)
//      and unsat (0) and, with early stop, its block exits; at n = max_iter
//      it latches the decisions and its count of unsatisfied checks.
//   2. in the same pass, unless n = max_iter: v2c = posterior - own c2v,
//      t = tanh(v2c / 2) (1 for a pad slot), the exclusive product as
//      _exclusive_prod forms it (log-magnitude sum, excluded sign and zero
//      counts, zero factors exact), clipped at +/-clip, and
//      c2v = log1p(te) - log1p(-te), written in place: the check's slots
//      belong to its thread alone.
//   3. one thread per variable: posterior = LLR + the sum of its slots'
//      messages.
// The sums of step 2 (dc logs) and step 3 (dv messages) are taken in
// torch's order for a reduction over a last dimension of that size on the
// card (torch_sum below), so that the kernel's float32 arithmetic is the
// eager decoder's, operation for operation.
//
// What bounds it: the special-function and float32 work of step 2 (tanhf,
// logf, expf and two log1pf a slot), which the card's per-SM pipes run;
// device memory carries only the LLRs in and the bits out, once a window.
// One block per SM (its shared memory) of 1,024 threads, the most a block
// may have (48 registers, no spills): at lifting 256 on an H100 an
// iteration of 1,024 frames took 0.20 ms, against 0.25 ms with 512 threads
// and 0.20-0.21 ms with 768. Each thread's checks run dc independent slot chains, which hide the
// latency of the math routines and of shared memory. Tried on the card and
// left out, none faster by more than 1 %: the check table in shared memory
// (with the LLRs in registers), the next check's indices loaded ahead, and
// skipping the math of saturated messages (whose results it fixes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr unsigned short PAD = 0xFFFF;
constexpr int KERNEL_DC = 6;  // the check degree of every window graph the port runs (ops/window_bp.py::fits)
constexpr int MAX_DV = 3;

// The sum of x[0..D) in the order torch's reduction takes it over a last
// dimension of D on the card (ATen's Reduce.cuh): lane j of the P lanes
// (P the largest power of two <= D) holds x[j] + x[j + P], then the lanes
// fold in halves, the upper half onto the lower, P / 2 first.
template <int D>
__device__ __forceinline__ float torch_sum(const float (&x)[D]) {
    constexpr int P = D >= 8 ? 8 : D >= 4 ? 4 : D >= 2 ? 2 : 1;
    static_assert(D < 2 * P, "at most two values a lane");
    float lane[P];
#pragma unroll
    for (int j = 0; j < P; ++j) lane[j] = j + P < D ? x[j] + x[j + P] : x[j];
#pragma unroll
    for (int off = P / 2; off >= 1; off /= 2) {
#pragma unroll
        for (int j = 0; j < off; ++j) lane[j] = lane[j] + lane[j + off];
    }
    return lane[0];
}

// Check c: the parity of its variables' current decisions and, if update,
// its new messages in place (steps 1 and 2 above).
template <int DC>
__device__ __forceinline__ int check_pass(int c, int M, const unsigned short* __restrict__ check_vars,
                                          const float* post, float* c2v, bool first, bool update, float clip) {
    unsigned short vi[DC];  // all of the check's loads in flight before the first use
#pragma unroll
    for (int k = 0; k < DC; ++k) vi[k] = __ldg(check_vars + k * M + c);
    float x[DC];
    unsigned valid = 0;
    int parity = 0;
#pragma unroll
    for (int k = 0; k < DC; ++k) {
        x[k] = 0.f;
        if (vi[k] != PAD) {
            valid |= 1u << k;
            x[k] = post[vi[k]];
            parity ^= first ? x[k] < 0.f : !(x[k] > 0.f);
        }
    }
    if (!update) return parity;
    unsigned zero = 0, neg = 0;
#pragma unroll
    for (int k = 0; k < DC; ++k) {
        float t = 1.f;
        if (valid >> k & 1) t = tanhf(__fmul_rn(x[k] - c2v[k * M + c], 0.5f));
        zero |= unsigned(t == 0.f) << k;
        neg |= unsigned(t < 0.f) << k;
        x[k] = logf(t == 0.f ? 1.f : fabsf(t));
    }
    const float sum_log = torch_sum<DC>(x);
    const int n_zero = __popc(zero), n_neg = __popc(neg);
#pragma unroll
    for (int k = 0; k < DC; ++k) {
        if (!(valid >> k & 1)) continue;
        float te = 0.f;
        if (n_zero == int(zero >> k & 1)) {
            const float mag = expf(sum_log - x[k]);
            te = (n_neg - int(neg >> k & 1)) & 1 ? -mag : mag;
        }
        te = te < -clip ? -clip : te > clip ? clip : te;  // keeps a NaN, as torch's clamp
        c2v[k * M + c] = log1pf(te) - log1pf(-te);
    }
    return parity;
}

// Every variable's posterior: its LLR plus its slots' messages (step 3).
template <int DV>
__device__ __forceinline__ void var_pass(int N, const unsigned short* __restrict__ var_slots, const float* c2v,
                                         const float* lch, float* post) {
    for (int v = threadIdx.x; v < N; v += THREADS) {
        float x[DV];
#pragma unroll
        for (int k = 0; k < DV; ++k) {
            const unsigned short e = __ldg(var_slots + k * N + v);
            x[k] = e == PAD ? 0.f : c2v[e];
        }
        post[v] = lch[v] + torch_sum<DV>(x);
    }
}

template <int DC>
__global__ void __launch_bounds__(THREADS, 1)
window_bp_kernel(const float* __restrict__ llr, long long llr_row, const unsigned short* __restrict__ check_vars,
                 const unsigned short* __restrict__ var_slots, int M, int N, int dv, int max_iter, int early_stop,
                 float clip, uint8_t* __restrict__ bits, uint8_t* __restrict__ success, int* __restrict__ iterations,
                 int* __restrict__ unsat, float* __restrict__ post_out) {
    extern __shared__ float smem[];
    float* c2v = smem;           // [DC][M]
    float* post = c2v + DC * M;  // [N]
    float* lch = post + N;       // [N]
    int* s_unsat = reinterpret_cast<int*>(lch + N);
    const int f = blockIdx.x, tid = threadIdx.x;
    const float* row = llr + f * llr_row;
    for (int v = tid; v < N; v += THREADS) {
        const float x = row[v];
        lch[v] = x;
        post[v] = x;
    }
    for (int e = tid; e < DC * M; e += THREADS) c2v[e] = 0.f;  // v2c = LLR - 0 in the first pass
    if (tid == 0) *s_unsat = 0;
    __syncthreads();
    bool latched = false;
    for (int n = 0;; ++n) {
        const bool last = n >= max_iter;
        int mine = 0;
        for (int c = tid; c < M; c += THREADS)
            mine += check_pass<DC>(c, M, check_vars, post, c2v, n == 0, !last, clip);
        if (last) {
            const int w = __reduce_add_sync(0xffffffffu, mine);
            if ((tid & 31) == 0 && w) atomicAdd(s_unsat, w);
        }
        const bool any = __syncthreads_or(mine);
        if (!latched && (!any || last)) {
            uint8_t* out = bits + (long long)f * N;
            for (int v = tid; v < N; v += THREADS) out[v] = n == 0 ? post[v] < 0.f : !(post[v] > 0.f);
            if (tid == 0) {
                iterations[f] = n;
                unsat[f] = any ? *s_unsat : 0;
                success[f] = !any;
            }
            latched = true;
        }
        if (last || (latched && early_stop)) break;
        switch (dv) {
            case 1: var_pass<1>(N, var_slots, c2v, lch, post); break;
            case 2: var_pass<2>(N, var_slots, c2v, lch, post); break;
            default: var_pass<3>(N, var_slots, c2v, lch, post); break;
        }
        __syncthreads();
    }
    if (post_out) {
        for (int v = tid; v < N; v += THREADS) post_out[(long long)f * N + v] = post[v];
    }
}

template <int DC>
int launch(const void* llr, long long llr_row, const void* check_vars, const void* var_slots, int B, int M, int N,
           int dv, int max_iter, int early_stop, float clip, void* bits, void* success, void* iterations, void* unsat,
           void* post, cudaStream_t stream) {
    auto kernel = window_bp_kernel<DC>;
    const int smem = int(sizeof(float)) * (DC * M + 2 * N) + 16;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    kernel<<<B, THREADS, smem, stream>>>(
        static_cast<const float*>(llr), llr_row, static_cast<const unsigned short*>(check_vars),
        static_cast<const unsigned short*>(var_slots), M, N, dv, max_iter, early_stop, clip,
        static_cast<uint8_t*>(bits), static_cast<uint8_t*>(success), static_cast<int*>(iterations),
        static_cast<int*>(unsat), static_cast<float*>(post));
    return int(cudaGetLastError());
}

}  // namespace

// BP of B frames on one window graph (see above). llr: float32 rows of N,
// llr_row elements apart; check_vars: uint16 [dc][M]; var_slots: uint16
// [dv][N]; dc = 6, 1 <= dv <= 3. Writes bits [B, N] uint8, success [B]
// bool, iterations and unsat [B] int32 and, where post is not null, the
// float32 posteriors [B, N] at exit. Returns cudaGetLastError() after the
// launch (0: no frames), or cudaErrorInvalidValue for degrees it does not take.
extern "C" int window_bp_launch(const void* llr, long long llr_row, const void* check_vars, const void* var_slots,
                                int B, int M, int N, int dc, int dv, int max_iter, int early_stop, float clip,
                                void* bits, void* success, void* iterations, void* unsat, void* post, void* stream) {
    if (B <= 0) return 0;
    if (dc != KERNEL_DC || dv < 1 || dv > MAX_DV) return int(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return launch<KERNEL_DC>(llr, llr_row, check_vars, var_slots, B, M, N, dv, max_iter, early_stop, clip, bits,
                             success, iterations, unsat, post, st);
}
