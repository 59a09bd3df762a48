// Fused flooding sum-product BP for a permutation-blocked (protograph)
// LDPC code: the Hopper port of the TPU kernel
// dna_ldpc_tpu/ops/bp_pallas.py::_bp_kernel.
//
// Design. One thread block decodes one codeword and runs its own
// iteration loop; with early_stop the block exits at its first zero
// syndrome, which gives the same latched bits/unsat/iterations as the TPU
// kernel's 64-codeword chunks (their results also latch per codeword).
// Without it (the TPU kernel's fixed-work mode) every block runs max_iter
// iterations and latches bits, unsat and iterations at its first zero
// syndrome, so both modes return the same words; only the work differs.
// One thread per check of the current coset (q threads). Per codeword:
//   - the f32 posterior [J*q] and the backward partial products [J][q]
//     live in shared memory (2 * 72 * 256 * 4 = 147,456 bytes for the
//     deployed 8 x 72 x 256 code);
//   - the bf16 tanh-domain messages [G, J, q] live in one global slab
//     (295 KB) that holds t = tanh(v2c / 2) before the check update and
//     c2v after it: the thread that reads slot (g, j, r) is the only one
//     that writes it, so one slab serves both phases.
// Routing is an exact indexed gather/scatter through pi[g, j, r] (the TPU
// builds a one-hot matrix for its matrix unit instead). Within a coset
// every variable receives exactly one edge, so the posterior update needs
// no atomics; cosets are accumulated in order g = 0..G-1 with a barrier
// between them, which keeps the TPU kernel's f32 summation order.
//
// Rounding points kept from the TPU kernel: v0 = bf16(llr); t =
// bf16(tanh(v / 2)); te = f32 forward*backward product of bf16 t, clipped
// to +-te_clip; c2v = bf16(log((1 + te) / (1 - te))); post = llr + sum_g
// c2v in f32; bits = !(post > 0); parity from !(bf16(post) > 0).
//
// What bounds it on the card: the per-check sequential sweeps over J
// (latency of dependent shared-memory and bf16 global accesses) with one
// 8-warp block per SM; memory traffic is ~0.6 MB per codeword per
// iteration, mostly L2-resident. Compiled without fast-math: tanhf and
// logf are the same libdevice routines PyTorch's CUDA tanh and log use,
// so the plain torch twin (ops/bp_cuda.py::bp_decode_blocked_ref) agrees
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

__global__ void bp_blocked_kernel(
    const float* __restrict__ llr_c,   // [B, J*q] canonical order, sanitized
    const int32_t* __restrict__ pi,    // [G, J, q]
    __nv_bfloat16* __restrict__ msg,   // [B, G, J, q] scratch
    uint8_t* __restrict__ bits_c,      // [B, J*q] canonical order (out)
    int32_t* __restrict__ unsat_out,   // [B]
    int32_t* __restrict__ iters_out,   // [B]
    int G, int J, int q, int max_iter, int early_stop, float te_clip)
{
    extern __shared__ float smem[];
    const int N = J * q;
    float* post = smem;       // [J*q]
    float* bbuf = smem + N;   // [J][q] backward partial products
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const bool active = r < q;
    const float* llr = llr_c + (size_t)b * N;
    __nv_bfloat16* m = msg + (size_t)b * G * N;
    uint8_t* bits = bits_c + (size_t)b * N;

    for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const float x = llr[k];
        post[k] = x;
        bits[k] = x < 0.0f;  // initial decision: lratio < 1
    }
    __syncthreads();

    // init: t = bf16(tanh(v0 / 2)) with v0 = bf16(llr) routed to the
    // check side; syndrome of the channel decisions from v0 < 0
    int unsat = 0;
    for (int g = 0; g < G; ++g) {
        int par = 0;
        if (active) {
            const int32_t* pg = pi + (size_t)g * N;
            __nv_bfloat16* mg = m + (size_t)g * N;
            for (int j = 0; j < J; ++j) {
                const float v0 = bf16_round(post[j * q + pg[j * q + r]]);
                mg[j * q + r] = __float2bfloat16(tanhf(v0 * 0.5f));
                par ^= (v0 < 0.0f);
            }
        }
        unsat += __syncthreads_count(par);
    }

    bool done = unsat == 0;  // uniform across the block
    int it = 0;
    for (int n = 0; n < max_iter && !(done && early_stop); ++n) {
        // phase B: check update + posterior accumulation, coset by coset
        for (int k = threadIdx.x; k < N; k += blockDim.x) post[k] = llr[k];
        __syncthreads();
        for (int g = 0; g < G; ++g) {
            if (active) {
                const int32_t* pg = pi + (size_t)g * N;
                __nv_bfloat16* mg = m + (size_t)g * N;
                float acc = 1.0f;
                bbuf[(J - 1) * q + r] = acc;
                for (int j = J - 2; j >= 0; --j) {
                    acc = __bfloat162float(mg[(j + 1) * q + r]) * acc;
                    bbuf[j * q + r] = acc;
                }
                float F = 1.0f;
                for (int j = 0; j < J; ++j) {
                    const float tj = __bfloat162float(mg[j * q + r]);
                    float te = F * bbuf[j * q + r];  // exclusive product
                    te = fminf(fmaxf(te, -te_clip), te_clip);
                    const __nv_bfloat16 c = __float2bfloat16(logf((1.0f + te) / (1.0f - te)));
                    post[j * q + pg[j * q + r]] += __bfloat162float(c);
                    mg[j * q + r] = c;  // the slab now holds c2v
                    F = F * tj;
                }
            }
            __syncthreads();
        }
        // latch decisions: pr <= 1 with NaN -> 1 == !(post > 0)
        if (!done)
            for (int k = threadIdx.x; k < N; k += blockDim.x) bits[k] = !(post[k] > 0.0f);

        // phase C: variable update + syndrome of the new decisions
        int new_unsat = 0;
        for (int g = 0; g < G; ++g) {
            int par = 0;
            if (active) {
                const int32_t* pg = pi + (size_t)g * N;
                __nv_bfloat16* mg = m + (size_t)g * N;
                for (int j = 0; j < J; ++j) {
                    const float pp = bf16_round(post[j * q + pg[j * q + r]]);
                    const float v = pp - __bfloat162float(mg[j * q + r]);
                    mg[j * q + r] = __float2bfloat16(tanhf(v * 0.5f));
                    par ^= !(pp > 0.0f);
                }
            }
            new_unsat += __syncthreads_count(par);
        }
        if (!done) {
            unsat = new_unsat;
            it = n + 1;
            done = new_unsat == 0;
        }
    }
    if (threadIdx.x == 0) {
        unsat_out[b] = unsat;
        iters_out[b] = it;
    }
}

}  // namespace

extern "C" int bp_blocked_launch(
    const void* llr_c, const void* pi, void* msg, void* bits_c, void* unsat,
    void* iters, int B, int G, int J, int q, int max_iter, int early_stop,
    float te_clip, void* stream)
{
    if (B == 0) return 0;
    const size_t smem = 2 * (size_t)J * q * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        bp_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int threads = ((q + 31) / 32) * 32;
    bp_blocked_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)llr_c, (const int32_t*)pi, (__nv_bfloat16*)msg,
        (uint8_t*)bits_c, (int32_t*)unsat, (int32_t*)iters, G, J, q, max_iter,
        early_stop, te_clip);
    return (int)cudaGetLastError();
}
