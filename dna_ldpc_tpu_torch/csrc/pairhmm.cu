// Pair-HMM match posteriors + EA scores for a batch of read pairs: the
// Hopper port of the TPU kernel dna_ldpc_tpu/ops/msa/pairhmm_pallas.py::
// _kernel (MUSCLE v5's 5-state pair-HMM, fwdflat3/bwdflat3/
// calcposteriorflat + CalcAlnScoreFlat).
//
// Design. One thread block per pair, one thread per DP row i = 0..Lmax.
// The DP is swept by antidiagonals d = i + j: every cell depends only on
// the two previous diagonals, which stay in shared memory as a ring of
// three diagonal buffers (6 states each, with a NEG guard cell at both
// ends so the i-1 / i+1 neighbours need no branches) — one barrier per
// diagonal. Three phases, the same recurrences and f32 operation order as
// the TPU kernel (and as the plain torch twin,
// ops/msa/pairhmm_cuda.py::post_ea_ref):
//   1. forward sweep; the forward M-plane goes to a global scratch buffer
//      ((2 Lmax + 1) x (Lmax + 1) f32 = 207 KB per pair at Lmax = 160, too
//      large to share the SM with other blocks) and the total probability
//      is captured at the pair's corner (lx, ly);
//   2. anti-causal backward sweep fused with the posterior
//      exp(min(F_M + B_M - total, 0)), zeroed below 0.01 and outside
//      [1..lx] x [1..ly], written straight into the compact
//      [P, Lmax, Lmax] layout;
//   3. the MEA max-DP over the bf16-rounded posterior just written; its
//      corner value is the EA score, bit-equal to the native mea_score on
//      the same bf16-rounded values.
//
// What bounds it on the card: 3 x (2 Lmax + 1) dependent steps with a
// block barrier each and ~30 expf/logf per cell (compute and latency, not
// bandwidth). Compiled without fast-math: expf/logf are the libdevice
// routines PyTorch's CUDA exp/log use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float MIN_PROB = 0.01f;

struct Consts {  // order of pairhmm.CONST_NAMES
    float tMM, tMIS, tMIL, tISM, tISIS, tILM, tILIL;
    float sM, sIS, sIL, eDIAG, eOTH, eW16, eMARG, eW4;
};

__device__ __forceinline__ float lse2(float a, float b) {
    const float m = fmaxf(a, b);
    float s = 0.0f;
    s += expf(a - m);
    s += expf(b - m);
    return m + logf(s);
}

__device__ __forceinline__ float lse3(float a, float b, float c) {
    const float m = fmaxf(fmaxf(a, b), c);
    float s = 0.0f;
    s += expf(a - m);
    s += expf(b - m);
    s += expf(c - m);
    return m + logf(s);
}

__device__ __forceinline__ float lse5(float a, float b, float c, float d, float e) {
    const float m = fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), e);
    float s = 0.0f;
    s += expf(a - m);
    s += expf(b - m);
    s += expf(c - m);
    s += expf(d - m);
    s += expf(e - m);
    return m + logf(s);
}

__device__ __forceinline__ float lse6(float a, float b, float c, float d, float e, float f) {
    const float m = fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(a, b), c), d), e), f);
    float s = 0.0f;
    s += expf(a - m);
    s += expf(b - m);
    s += expf(c - m);
    s += expf(d - m);
    s += expf(e - m);
    s += expf(f - m);
    return m + logf(s);
}

__device__ __forceinline__ float m_emit(const Consts& C, int a, int b) {
    return (a == 4 || b == 4) ? C.eW16 : (a == b ? C.eDIAG : C.eOTH);
}

__device__ __forceinline__ float i_emit(const Consts& C, int a) {
    return a == 4 ? C.eW4 : C.eMARG;
}

__global__ void pairhmm_kernel(
    const int8_t* __restrict__ xc, const int8_t* __restrict__ yc,  // [P, Lmax]
    const int32_t* __restrict__ lxs, const int32_t* __restrict__ lys,  // [P]
    const float* __restrict__ consts,  // [15]
    float* __restrict__ fwdm,          // [P, D+1, W] scratch
    float* __restrict__ post,          // [P, Lmax, Lmax] out
    float* __restrict__ ea,            // [P] out
    int Lmax)
{
    extern __shared__ float sm[];
    const int W = Lmax + 1, D = 2 * Lmax, WG = W + 2;
    float* st = sm;                                  // [3][6][W+2] diagonal ring
    int* xs = (int*)(st + 3 * 6 * WG);               // [Lmax+2]
    int* ys = xs + (Lmax + 2);                       // [Lmax+2]
    float* shared_f = (float*)(ys + (Lmax + 2));     // corner[5], total, best
    const Consts C = *reinterpret_cast<const Consts*>(consts);

    const int p = blockIdx.x;
    const int i = threadIdx.x;
    const bool row = i < W;
    const int lx = lxs[p], ly = lys[p], lsum = lx + ly;
    float* fm = fwdm + (size_t)p * (D + 1) * W;
    float* out = post + (size_t)p * Lmax * Lmax;
#define BUF(slot, s, k) st[((slot) * 6 + (s)) * WG + (k) + 1]

    for (int k = threadIdx.x; k < Lmax + 2; k += blockDim.x) {
        const bool in = k >= 1 && k <= Lmax;
        xs[k] = in ? (int)xc[(size_t)p * Lmax + k - 1] : 4;
        ys[k] = in ? (int)yc[(size_t)p * Lmax + k - 1] : 4;
    }
    for (int k = threadIdx.x; k < 3 * 6 * WG; k += blockDim.x) st[k] = NEG;
    if (threadIdx.x < 7) shared_f[threadIdx.x] = NEG;
    __syncthreads();
    if (threadIdx.x == 0) BUF(0, 5, 0) = 0.0f;  // START at (0, 0), diagonal 0
    if (row) fm[i] = NEG;
    __syncthreads();

    // ---- phase 1: forward sweep -----------------------------------------
    const int xi = row ? xs[i] : 4;
    for (int d = 1; d <= D; ++d) {
        const int c0 = d % 3, c1 = (d + 2) % 3, c2 = (d + 1) % 3;
        if (row) {
            const int j = d - i;
            const int yj = (j >= 1 && j <= Lmax) ? ys[j] : 4;
            float cM = lse6(BUF(c2, 0, i - 1) + C.tMM, BUF(c2, 1, i - 1) + C.tISM,
                            BUF(c2, 2, i - 1) + C.tISM, BUF(c2, 3, i - 1) + C.tILM,
                            BUF(c2, 4, i - 1) + C.tILM, BUF(c2, 5, i - 1) + C.sM)
                       + m_emit(C, xi, yj);
            const float sMm = BUF(c1, 0, i - 1), sIX = BUF(c1, 1, i - 1);
            const float sJX = BUF(c1, 3, i - 1), sS = BUF(c1, 5, i - 1);
            const float xe = i_emit(C, xi), ye = i_emit(C, yj);
            float cIX = lse3(sMm + C.tMIS, sIX + C.tISIS, sS + C.sIS) + xe;
            float cJX = lse3(sMm + C.tMIL, sJX + C.tILIL, sS + C.sIL) + xe;
            float cIY = lse3(BUF(c1, 0, i) + C.tMIS, BUF(c1, 2, i) + C.tISIS,
                             BUF(c1, 5, i) + C.sIS) + ye;
            float cJY = lse3(BUF(c1, 0, i) + C.tMIL, BUF(c1, 4, i) + C.tILIL,
                             BUF(c1, 5, i) + C.sIL) + ye;
            const bool valid = j >= 0 && j <= Lmax;
            if (!(valid && i >= 1 && j >= 1)) cM = NEG;
            if (!(valid && i >= 1)) { cIX = NEG; cJX = NEG; }
            if (!(valid && j >= 1)) { cIY = NEG; cJY = NEG; }
            BUF(c0, 0, i) = cM;
            BUF(c0, 1, i) = cIX;
            BUF(c0, 2, i) = cIY;
            BUF(c0, 3, i) = cJX;
            BUF(c0, 4, i) = cJY;
            BUF(c0, 5, i) = NEG;
            fm[(size_t)d * W + i] = cM;
            if (i == lx && d == lsum) {
                shared_f[0] = cM; shared_f[1] = cIX; shared_f[2] = cIY;
                shared_f[3] = cJX; shared_f[4] = cJY;
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        shared_f[5] = lse5(shared_f[0] + C.sM, shared_f[1] + C.sIS, shared_f[2] + C.sIS,
                           shared_f[3] + C.sIL, shared_f[4] + C.sIL);
    }
    for (int k = threadIdx.x; k < 3 * 6 * WG; k += blockDim.x) st[k] = NEG;
    __syncthreads();
    const float total = shared_f[5];

    // ---- phase 2: backward sweep + fused posterior -----------------------
    const int xn = row ? xs[i + 1] : 4;
    for (int d = D; d >= 0; --d) {
        const int k = D - d;
        const int c0 = k % 3, c1 = (k + 2) % 3, c2 = (k + 1) % 3;
        if (row) {
            const int j = d - i;
            const int yn = (j + 1 >= 1 && j + 1 <= Lmax) ? ys[j + 1] : 4;
            const float ex = i_emit(C, xn), ey = i_emit(C, yn);
            const float aM = m_emit(C, xn, yn) + BUF(c2, 0, i + 1);
            const float aIX = ex + BUF(c1, 1, i + 1);
            const float aJX = ex + BUF(c1, 3, i + 1);
            const float aIY = ey + BUF(c1, 2, i);
            const float aJY = ey + BUF(c1, 4, i);
            float bM = lse5(aM + C.tMM, aIX + C.tMIS, aIY + C.tMIS, aJX + C.tMIL, aJY + C.tMIL);
            float bIX = lse2(aM + C.tISM, aIX + C.tISIS);
            float bIY = lse2(aM + C.tISM, aIY + C.tISIS);
            float bJX = lse2(aM + C.tILM, aJX + C.tILIL);
            float bJY = lse2(aM + C.tILM, aJY + C.tILIL);
            if (i == lx && d == lsum) {  // terminal: Bwd[s](lx, ly) = start[s]
                bM = C.sM; bIX = C.sIS; bIY = C.sIS; bJX = C.sIL; bJY = C.sIL;
            }
            BUF(c0, 0, i) = bM;
            BUF(c0, 1, i) = bIX;
            BUF(c0, 2, i) = bIY;
            BUF(c0, 3, i) = bJX;
            BUF(c0, 4, i) = bJY;
            if (i >= 1 && j >= 1 && j <= Lmax) {
                float pst = expf(fminf(fm[(size_t)d * W + i] + bM - total, 0.0f));
                const bool ok = i <= lx && j <= ly && pst >= MIN_PROB;
                out[(size_t)(i - 1) * Lmax + (j - 1)] = ok ? pst : 0.0f;
            }
        }
        __syncthreads();
    }

    // ---- phase 3: MEA max-DP over the bf16-rounded posterior --------------
    for (int k = threadIdx.x; k < 3 * 6 * WG; k += blockDim.x) st[k] = NEG;
    __syncthreads();
    if (threadIdx.x == 0) BUF(0, 0, 0) = 0.0f;  // S(0, 0)
    __syncthreads();
    for (int d = 1; d <= D; ++d) {
        const int c0 = d % 3, c1 = (d + 2) % 3, c2 = (d + 1) % 3;
        if (row) {
            const int j = d - i;
            float pq = 0.0f;
            if (i >= 1 && j >= 1 && j <= Lmax)
                pq = __bfloat162float(__float2bfloat16(out[(size_t)(i - 1) * Lmax + (j - 1)]));
            float cur = fmaxf(fmaxf(BUF(c2, 0, i - 1) + pq, BUF(c1, 0, i - 1)), BUF(c1, 0, i));
            const bool valid = j >= 0 && j <= Lmax;
            if (valid && (i == 0 || j == 0)) cur = 0.0f;
            if (!valid) cur = NEG;
            BUF(c0, 0, i) = cur;
            if (i == lx && d == lsum) shared_f[6] = cur;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) ea[p] = lsum >= 1 ? fmaxf(shared_f[6], 0.0f) : 0.0f;
#undef BUF
}

}  // namespace

extern "C" int pairhmm_launch(
    const void* xc, const void* yc, const void* lx, const void* ly,
    const void* consts, void* fwdm, void* post, void* ea, int P, int Lmax,
    void* stream)
{
    if (P == 0) return 0;
    const int W = Lmax + 1;
    const size_t smem = (size_t)3 * 6 * (W + 2) * sizeof(float)
                      + (size_t)2 * (Lmax + 2) * sizeof(int) + 8 * sizeof(float);
    const int threads = ((W + 31) / 32) * 32;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            pairhmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    pairhmm_kernel<<<P, threads, smem, (cudaStream_t)stream>>>(
        (const int8_t*)xc, (const int8_t*)yc, (const int32_t*)lx, (const int32_t*)ly,
        (const float*)consts, (float*)fwdm, (float*)post, (float*)ea, Lmax);
    return (int)cudaGetLastError();
}
