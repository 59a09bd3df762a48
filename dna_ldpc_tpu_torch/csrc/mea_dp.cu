// MEA max-DP + traceback of the device MSA's batched profile merges: the
// Hopper kernel that replaces the XLA scans _mea_forward + _walk of
// dna_ldpc_tpu/ops/msa/device_msa.py (:212, :257) — MUSCLE v5's
// CalcAlnFlat + TraceBackFlat over a profile-profile posterior.
//
// Design. One thread block per cluster, one thread per DP lane
// i = 0..Cmax. The DP is swept by antidiagonals d = i + j = 1..2 Cmax over
// the full (Cmax + 1) x (Cmax + 1) plane (not bounded by the operands'
// widths); every cell depends only on the two previous diagonals, which
// stay in shared memory as a ring of three diagonal buffers with a NEG
// guard cell for lane -1 — one barrier per diagonal. Each thread reads its
// operand post[c, i-1, j-1] straight from global memory (prefetched one
// diagonal ahead), so the TPU's skewed diagonal plane is not needed. The
// per-cell choice code goes to a [2 Cmax, Cmax + 1] uint8 plane in shared
// memory (74 KB at Cmax = 192, 164 KB at the Cmax = 286 bound); one thread
// then walks it back from (wA, wB) and the block writes codes / pos for
// every diagonal (0 where the path skips it), exactly as _walk returns
// them.
//
// Semantics kept bit for bit with the plain twin
// (ops/msa/mea_cuda.py::mea_walk_ref) and the JAX scans: f32 values with
// NEG = -3e38 for unreachable cells (one add per cell, nothing to fuse),
// the tie order B >= X >= Y, the boundary codes (i == 0 -> Y, j == 0 -> X,
// value 0), cells with j < 0 code 0, and a walk that moves one diagonal
// back without stepping i when it meets a code-0 cell.
//
// What bounds it on the card: 2 Cmax dependent diagonal steps with a block
// barrier each (latency), and the uncoalesced diagonal reads of the
// posterior (Cmax^2 f32 per cluster, L2-resident); the prefetch hides the
// read latency behind the previous diagonal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr uint8_t CB = 1, CX = 2, CY = 3;

__device__ __forceinline__ float post_at(const float* pc, int i, int j, int Cmax) {
    // the operand of cell (i, j): post[i-1, j-1], 0 outside the plane
    return (i >= 1 && j >= 1 && j <= Cmax) ? pc[(size_t)(i - 1) * Cmax + (j - 1)] : 0.0f;
}

__global__ void mea_dp_kernel(const float* __restrict__ post, const int32_t* __restrict__ wA,
                              const int32_t* __restrict__ wB, uint8_t* __restrict__ codes,
                              int32_t* __restrict__ pos, int Cmax)
{
    extern __shared__ float smem[];
    const int W = Cmax + 1, D = 2 * Cmax, WG = W + 1;
    float* ring = smem;                                   // [3][WG], lane i at i + 1
    int32_t* opos = (int32_t*)(ring + 3 * WG);            // [D]
    uint8_t* ocode = (uint8_t*)(opos + D);                // [D]
    uint8_t* plane = ocode + D;                           // [D][W]
#define RING(k, lane) ring[(k) * WG + (lane) + 1]

    const int c = blockIdx.x;
    const int i = threadIdx.x;
    const bool row = i < W;
    const float* pc = post + (size_t)c * Cmax * Cmax;

    for (int k = threadIdx.x; k < 3 * WG; k += blockDim.x) ring[k] = NEG;
    __syncthreads();
    if (threadIdx.x == 0) RING(0, 0) = 0.0f;  // diagonal 0: cell (0, 0)
    __syncthreads();

    float pv = row ? post_at(pc, i, 1 - i, Cmax) : 0.0f;
    for (int d = 1; d <= D; ++d) {
        const int cur = d % 3, p1 = (d + 2) % 3, p2 = (d + 1) % 3;
        const int j = d - i;
        const float pv_next = (row && d < D) ? post_at(pc, i, j + 1, Cmax) : 0.0f;
        if (row) {
            const float pB = RING(p2, i - 1) + pv;
            const float pX = RING(p1, i - 1);
            const float pY = RING(p1, i);
            float val;
            uint8_t code;
            if (pB >= pX) {
                if (pB >= pY) { val = pB; code = CB; } else { val = pY; code = CY; }
            } else {
                if (pX >= pY) { val = pX; code = CX; } else { val = pY; code = CY; }
            }
            if (i == 0) { val = 0.0f; code = CY; }
            else if (j == 0) { val = 0.0f; code = CX; }
            if (j < 0) { val = NEG; code = 0; }
            RING(cur, i) = val;
            plane[(size_t)(d - 1) * W + i] = code;
        }
        __syncthreads();
        pv = pv_next;
    }

    if (threadIdx.x == 0) {
        int ic = wA[c], dc = wA[c] + wB[c];
        for (int d = D; d >= 1; --d) {
            uint8_t code = 0;
            int p = 0;
            if (dc == d) {
                code = (ic >= 0 && ic < W) ? plane[(size_t)(d - 1) * W + ic] : 0;
                p = ic;
                if (code == CB || code == CX) ic -= 1;
                dc = code == CB ? dc - 2 : dc - 1;
            }
            ocode[d - 1] = code;
            opos[d - 1] = p;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < D; k += blockDim.x) {
        codes[(size_t)c * D + k] = ocode[k];
        pos[(size_t)c * D + k] = opos[k];
    }
#undef RING
}

}  // namespace

extern "C" int mea_dp_launch(const void* post, const void* wA, const void* wB, void* codes,
                             void* pos, int C, int Cmax, void* stream)
{
    if (C == 0) return 0;
    const int W = Cmax + 1, D = 2 * Cmax;
    const size_t smem = (size_t)3 * (W + 1) * sizeof(float) + (size_t)D * sizeof(int32_t)
                      + (size_t)D + (size_t)D * W;
    const int threads = ((W + 31) / 32) * 32;
    if (threads > 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            mea_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    mea_dp_kernel<<<C, threads, smem, (cudaStream_t)stream>>>(
        (const float*)post, (const int32_t*)wA, (const int32_t*)wB, (uint8_t*)codes,
        (int32_t*)pos, Cmax);
    return (int)cudaGetLastError();
}
