// Pair-HMM match posteriors + EA scores for a batch of read pairs: the
// Hopper port of the TPU kernel dna_ldpc_tpu/ops/msa/pairhmm_pallas.py::
// _kernel (MUSCLE v5's 5-state pair-HMM, fwdflat3/bwdflat3/
// calcposteriorflat + CalcAlnScoreFlat).
//
// What it computes: the same recurrences, in the same f32 operation order
// inside every log-sum-exp, as the TPU kernel and the plain torch twin
// (ops/msa/pairhmm_cuda.py::post_ea_ref). A cell's value depends only on
// its three neighbours, so the order in which cells are swept does not
// change a bit of it.
//   1. forward sweep over rows 0..lx and columns 0..ly; the forward M
//      values go to a global scratch, and the total probability is taken
//      at the pair's corner (lx, ly);
//   2. backward sweep over the box [1..lx] x [1..ly] (every cell outside it
//      is exactly -1e30 in the full-plane recurrence, and is taken as
//      that) fused with the posterior exp(min(F_M + B_M - total, 0)),
//      zeroed below 0.01, written into the compact [P, Lmax, Lmax] layout
//      (zeros outside the box);
//   3. the MEA max-DP over the bf16-rounded posterior, run backward on the
//      same sweep as the posteriors appear: U(i, j) = max(U(i+1, j+1) +
//      p(i, j), U(i+1, j), U(i, j+1)), EA = U(1, 1). Every p is a bf16
//      value in [2^-7, 1] (a multiple of 2^-14) and a path has at most 1023
//      of them, so every partial sum fits f32's 24 bits exactly: the score
//      is the exact maximum whatever the direction, bit-equal to the native
//      forward mea_score on the same bf16-rounded values.
// The START state is 0 at cell (0, 0) and -1e30 elsewhere; its term adds
// exactly +0 to a log-sum-exp whose maximum is finite, and leaves an
// all--1e30 one at -1e30, so only the cells (0, 1), (1, 0) and (1, 1) carry
// it.
//
// Design: a warp wavefront in registers. One warp per pair, four pairs per
// block, no block barrier. Lane l owns a strip of R = ceil((lx + 1) / 32)
// consecutive rows (at most 6) and sweeps the columns one step behind lane
// l - 1: at step s it computes column s - l of its rows, taking the last
// row of lane l - 1 (the five states at that column; the column before
// it was taken a step earlier) with __shfl_up_sync. The backward sweep is
// the mirror image with __shfl_down_sync. A lane's R cells of a step are
// independent but for the IX/JX chain down the strip, which hides the
// expf -> sum -> logf latency; the sweeps are compiled once per R (a
// template parameter), so a step is one straight block of R cells with no
// branch per row. Work stops at lx and ly, not at Lmax.
// A pair's two reads are rows of read tables named by two index arrays, so
// a read that takes part in many pairs is packed and uploaded once; the
// warp copies its two rows into shared memory before the sweeps.
// Reads longer than 32 x 6 - 1 rows are swept in bands of 192 rows; a
// band's last row crosses to the next band through a small global edge
// buffer (two slots of 5 x (Lmax + 1) f32 per pair).
// The forward M scratch is laid out [band][step][row of strip][lane]: a
// step's stores are 128-byte coalesced, the backward sweep reads the same
// line back at the mirrored step (column + lane is the forward step for
// every lane), and each lane reads only what it wrote itself, one step
// ahead of its use. Per pair it holds (ly + 32) x R x 32 f32 (116 KB at
// lx = ly = 150).
//
// What bounds it on the card: operations. Per cell 13 expf + 5 logf
// forward, 14 expf + 5 logf backward, libdevice routines without
// fast-math (the ones PyTorch's CUDA exp/log use; ~24 SASS operations per
// special-function operation as compiled), ~23k cells per pair of 150-nt
// reads; the bytes that must move (the f32 posteriors out, 102 KB per
// pair at Lmax = 160) take a tenth of that time. On an H100 a launch of
// 6,000 pairs reached 17 % of that bound and one of 512 pairs (fewer warps
// than the card has schedulers) 8 %; what stalls the rest is not profiled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float MIN_PROB = 0.01f;
constexpr int RMAX = 6;          // rows of a lane's strip (pairhmm_cuda.STRIP_ROWS)
constexpr int WARPS = 4;         // pairs per block, one warp each
constexpr unsigned FULL = 0xffffffffu;

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

// The three phases of one pair on its warp, with R rows in every lane's
// strip: R is a template parameter so that a step is one straight block of
// R independent cells (no branch per row). Rows past lx in the last lane
// are computed like any other and never used: forward they feed nothing,
// backward they are -1e30 as in the full-plane recurrence.
template <int R>
__device__ void sweep_pair(
    const Consts& C, const signed char* xs, const signed char* ys, int lx, int ly, int nb, int W,
    int Lmax, float* fm, float* eg, float* out, float* ea_p, int lane)
{
    const int rows = lx + 1;
    const size_t band_floats = (size_t)(ly + 32) * R * 32;

    // ---- phase 1: forward sweep -----------------------------------------
    float tot = NEG;  // set by the lane that owns the corner (lx, ly)
    for (int b = 0; b < nb; ++b) {
        const int row0 = b * 32 * R;
        const int rows_b = min(32 * R, rows - row0);
        const int NL = (rows_b + R - 1) / R;  // lanes with a row
        const float* ein = eg + ((b + 1) & 1) * 5 * W;
        float* eout = eg + (b & 1) * 5 * W;
        const bool has_next = b + 1 < nb;
        float* fmb = fm + b * band_floats;
        const int i0 = row0 + lane * R;

        float M[R], IX[R], IY[R], JX[R], JY[R];  // my rows at the column before
        int xi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            M[r] = IX[r] = IY[r] = JX[r] = JY[r] = NEG;  // column -1
            xi[r] = i0 + r <= lx ? (int)xs[i0 + r] : 4;
        }
        float pM = NEG, pIX = NEG, pIY = NEG, pJX = NEG, pJY = NEG;  // row above, column before

        const int steps = ly + NL;
        for (int s = 0; s < steps; ++s) {
            const int j = s - lane;
            // the row above my strip at column j: lane - 1 computed it one step ago
            float uM = __shfl_up_sync(FULL, M[R - 1], 1), uIX = __shfl_up_sync(FULL, IX[R - 1], 1);
            float uIY = __shfl_up_sync(FULL, IY[R - 1], 1), uJX = __shfl_up_sync(FULL, JX[R - 1], 1);
            float uJY = __shfl_up_sync(FULL, JY[R - 1], 1);
            if (lane == 0) {
                uM = uIX = uIY = uJX = uJY = NEG;
                if (b > 0 && j <= ly) {
                    uM = ein[0 * W + j]; uIX = ein[1 * W + j]; uIY = ein[2 * W + j];
                    uJX = ein[3 * W + j]; uJY = ein[4 * W + j];
                }
            }
            if (lane < NL && j >= 0 && j <= ly) {
                const int yj = j >= 1 ? (int)ys[j] : 4;
                const float ye = i_emit(C, yj);
                float dM = pM, dIX = pIX, dIY = pIY, dJX = pJX, dJY = pJY;  // (i-1, j-1)
                float aM = uM, aIX = uIX, aJX = uJX;                        // (i-1, j)
                if (i0 <= 1 && j <= 1) {  // the cells START reaches: rows 0 and 1, columns 0 and 1
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const int i = i0 + r;
                        const float oM = M[r], oIX = IX[r], oIY = IY[r], oJX = JX[r], oJY = JY[r];  // (i, j-1)
                        const float sD = (i == 1 && j == 1) ? 0.0f : NEG;
                        const float sU = (i == 1 && j == 0) ? 0.0f : NEG;
                        const float sL = (i == 0 && j == 1) ? 0.0f : NEG;
                        const float xe = i_emit(C, xi[r]);
                        float cM = lse6(dM + C.tMM, dIX + C.tISM, dIY + C.tISM, dJX + C.tILM, dJY + C.tILM,
                                        sD + C.sM) + m_emit(C, xi[r], yj);
                        float cIX = lse3(aM + C.tMIS, aIX + C.tISIS, sU + C.sIS) + xe;
                        float cJX = lse3(aM + C.tMIL, aJX + C.tILIL, sU + C.sIL) + xe;
                        float cIY = lse3(oM + C.tMIS, oIY + C.tISIS, sL + C.sIS) + ye;
                        float cJY = lse3(oM + C.tMIL, oJY + C.tILIL, sL + C.sIL) + ye;
                        if (i < 1 || j < 1) cM = NEG;
                        if (i < 1) { cIX = NEG; cJX = NEG; }
                        if (j < 1) { cIY = NEG; cJY = NEG; }
                        M[r] = cM; IX[r] = cIX; IY[r] = cIY; JX[r] = cJX; JY[r] = cJY;
                        dM = oM; dIX = oIX; dIY = oIY; dJX = oJX; dJY = oJY;
                        aM = cM; aIX = cIX; aJX = cJX;
                    }
                } else {
                    // row 0 at columns >= 2 needs no guard: its inputs from row -1 are
                    // -1e30, and -1e30 plus a log of a count plus an emission is -1e30
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float oM = M[r], oIX = IX[r], oIY = IY[r], oJX = JX[r], oJY = JY[r];  // (i, j-1)
                        const float xe = i_emit(C, xi[r]);
                        float cM = lse5(dM + C.tMM, dIX + C.tISM, dIY + C.tISM, dJX + C.tILM, dJY + C.tILM)
                                   + m_emit(C, xi[r], yj);
                        float cIX = lse2(aM + C.tMIS, aIX + C.tISIS) + xe;
                        float cJX = lse2(aM + C.tMIL, aJX + C.tILIL) + xe;
                        float cIY = lse2(oM + C.tMIS, oIY + C.tISIS) + ye;
                        float cJY = lse2(oM + C.tMIL, oJY + C.tILIL) + ye;
                        if (j < 1) { cM = NEG; cIY = NEG; cJY = NEG; }
                        M[r] = cM; IX[r] = cIX; IY[r] = cIY; JX[r] = cJX; JY[r] = cJY;
                        dM = oM; dIX = oIX; dIY = oIY; dJX = oJX; dJY = oJY;
                        aM = cM; aIX = cIX; aJX = cJX;
                    }
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    fmb[((size_t)s * R + r) * 32 + lane] = M[r];
                    if (i0 + r == lx && j == ly)
                        tot = lse5(M[r] + C.sM, IX[r] + C.sIS, IY[r] + C.sIS, JX[r] + C.sIL, JY[r] + C.sIL);
                }
                if (has_next && lane == 31) {
                    eout[0 * W + j] = M[R - 1]; eout[1 * W + j] = IX[R - 1]; eout[2 * W + j] = IY[R - 1];
                    eout[3 * W + j] = JX[R - 1]; eout[4 * W + j] = JY[R - 1];
                }
            }
            pM = uM; pIX = uIX; pIY = uIY; pJX = uJX; pJY = uJY;
        }
        __syncwarp();  // the band's edge row is visible to lane 0 of the next band
    }
    const int last_row0 = (nb - 1) * 32 * R;
    const float total = __shfl_sync(FULL, tot, (lx - last_row0) / R);

    // ---- phase 2 + 3: backward sweep, posterior, MEA max-DP ---------------
    float u11 = 0.0f;  // U(1, 1), on the lane that owns row 1
    for (int b = nb - 1; b >= 0; --b) {
        const int row0 = b * 32 * R;
        const int rows_b = min(32 * R, rows - row0);
        const int NL = (rows_b + R - 1) / R;
        const float* ein = eg + ((b + 1) & 1) * 5 * W;  // top row of band b + 1
        float* eout = eg + (b & 1) * 5 * W;
        const bool has_next = b + 1 < nb;
        const float* fmb = fm + b * band_floats;
        const int i0 = row0 + lane * R;

        float bM[R], bIY[R], bJY[R], U[R];  // my rows at the column after
        int xn[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            bM[r] = bIY[r] = bJY[r] = NEG;
            U[r] = 0.0f;
            xn[r] = i0 + r <= lx ? (int)xs[i0 + r + 1] : 4;
        }
        float topIX = NEG, topJX = NEG;  // my first row, current column (with bM[0], U[0])
        float pM = NEG, pU = 0.0f;       // row below, column after

        const int steps = ly + NL;
        // forward M of my rows at the current and the next step: the loads
        // are started a whole step before their first use
        float fcur[R], fnxt[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            fcur[r] = fmb[((size_t)(steps - 1) * R + r) * 32 + lane];
            fnxt[r] = 0.0f;
        }
        for (int t = 0; t < steps; ++t) {
            const int j = ly + (NL - 1) - t - lane;
            if (t + 1 < steps) {
#pragma unroll
                for (int r = 0; r < R; ++r) fnxt[r] = fmb[((size_t)(steps - 2 - t) * R + r) * 32 + lane];
            }
            // the row below my strip at column j: lane + 1 computed it one step ago
            float nM = __shfl_down_sync(FULL, bM[0], 1), nIX = __shfl_down_sync(FULL, topIX, 1);
            float nJX = __shfl_down_sync(FULL, topJX, 1), nU = __shfl_down_sync(FULL, U[0], 1);
            if (lane >= NL - 1) {
                nM = nIX = nJX = NEG;
                nU = 0.0f;
                if (has_next && lane == NL - 1 && j >= 1 && j <= ly) {
                    nM = ein[0 * W + j]; nIX = ein[1 * W + j]; nJX = ein[2 * W + j]; nU = ein[3 * W + j];
                }
            }
            if (lane < NL && j >= 1 && j <= ly) {
                const int yn = (int)ys[j + 1];
                const float ey = i_emit(C, yn);
                // fcur holds forward step j + lane = steps - 1 - t, the one that stored this column
                float dM = pM, dU = pU;               // (i+1, j+1)
                float aIX = nIX, aJX = nJX, aU = nU;  // (i+1, j)
#pragma unroll
                for (int r = R - 1; r >= 0; --r) {
                    const int i = i0 + r;
                    const float oM = bM[r], oU = U[r];  // (i, j+1)
                    const float ex = i_emit(C, xn[r]);
                    const float vM = m_emit(C, xn[r], yn) + dM;
                    const float vIX = ex + aIX, vJX = ex + aJX;
                    const float vIY = ey + bIY[r], vJY = ey + bJY[r];
                    float cM = lse5(vM + C.tMM, vIX + C.tMIS, vIY + C.tMIS, vJX + C.tMIL, vJY + C.tMIL);
                    float cIX = lse2(vM + C.tISM, vIX + C.tISIS);
                    float cIY = lse2(vM + C.tISM, vIY + C.tISIS);
                    float cJX = lse2(vM + C.tILM, vJX + C.tILIL);
                    float cJY = lse2(vM + C.tILM, vJY + C.tILIL);
                    if (i == lx && j == ly) {  // terminal: Bwd[s](lx, ly) = start[s]
                        cM = C.sM; cIX = C.sIS; cIY = C.sIS; cJX = C.sIL; cJY = C.sIL;
                    }
                    const bool in_box = i >= 1 && i <= lx;
                    float pst = expf(fminf(fcur[r] + cM - total, 0.0f));
                    if (!(in_box && pst >= MIN_PROB)) pst = 0.0f;
                    if (in_box) out[(size_t)(i - 1) * Lmax + (j - 1)] = pst;
                    const float pq = __bfloat162float(__float2bfloat16(pst));
                    const float cU = fmaxf(fmaxf(dU + pq, aU), oU);
                    bM[r] = cM; bIY[r] = cIY; bJY[r] = cJY; U[r] = cU;
                    dM = oM; dU = oU;
                    aIX = cIX; aJX = cJX; aU = cU;
                }
                topIX = aIX; topJX = aJX;
                if (b > 0 && lane == 0) {
                    eout[0 * W + j] = bM[0]; eout[1 * W + j] = topIX; eout[2 * W + j] = topJX;
                    eout[3 * W + j] = U[0];
                }
            }
            pM = nM; pU = nU;
#pragma unroll
            for (int r = 0; r < R; ++r) fcur[r] = fnxt[r];
        }
        __syncwarp();
        if (b == 0) u11 = U[R == 1 ? 0 : 1];
    }
    u11 = __shfl_sync(FULL, u11, R == 1 ? 1 : 0);
    if (lane == 0) *ea_p = fmaxf(u11, 0.0f);
}

__global__ void __launch_bounds__(WARPS * 32) pairhmm_kernel(
    const int8_t* __restrict__ xc, const int8_t* __restrict__ yc,  // read tables [Rx, Lmax], [Ry, Lmax]
    const int32_t* __restrict__ lxs, const int32_t* __restrict__ lys,  // their lengths [Rx], [Ry]
    const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,  // [P] rows of pair p, or null: row p
    const float* __restrict__ consts,  // [15]
    float* __restrict__ fwdm,          // [P, fm_stride] scratch
    float* __restrict__ edge,          // [P, 2, 5, Lmax + 1] scratch (Lmax + 1 > 32 * RMAX only)
    float* __restrict__ post,          // [P, Lmax, Lmax] out
    float* __restrict__ ea,            // [P] out
    int P, int Lmax, long long fm_stride)
{
    extern __shared__ signed char chars[];  // [WARPS][2][SL]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = blockIdx.x * WARPS + warp;
    if (p >= P) return;  // whole warps leave; the kernel has no block barrier
    const int W = Lmax + 1;
    const int SL = (Lmax + 2 + 3) & ~3;
    signed char* xs = chars + (size_t)warp * 2 * SL;  // xs[k]: x char at 1-based position k
    signed char* ys = xs + SL;
    const Consts C = *reinterpret_cast<const Consts*>(consts);
    const int ra = ia ? ia[p] : p, rb = ib ? ib[p] : p;  // the pair's two rows
    const int lx = lxs[ra], ly = lys[rb];
    float* out = post + (size_t)p * Lmax * Lmax;

    // zeros outside the pair's box
    for (int row = 0; row < Lmax; ++row)
        for (int c = (row < lx ? ly : 0) + lane; c < Lmax; c += 32) out[(size_t)row * Lmax + c] = 0.0f;
    if (lx == 0 || ly == 0) {
        if (lane == 0) ea[p] = 0.0f;
        return;
    }
    for (int k = lane; k < Lmax + 2; k += 32) {
        const bool in = k >= 1 && k <= Lmax;
        xs[k] = in ? xc[(size_t)ra * Lmax + k - 1] : (int8_t)4;
        ys[k] = in ? yc[(size_t)rb * Lmax + k - 1] : (int8_t)4;
    }
    __syncwarp();

    const int rows = lx + 1;
    const int nb = (rows + 32 * RMAX - 1) / (32 * RMAX);   // bands of rows
    const int R = nb == 1 ? (rows + 31) / 32 : RMAX;        // rows of a strip
    float* fm = fwdm + (size_t)p * fm_stride;
    float* eg = edge + (size_t)p * 2 * 5 * W;  // touched only when nb > 1
    static_assert(RMAX == 6, "one case per strip height");
    switch (R) {
        case 1: sweep_pair<1>(C, xs, ys, lx, ly, nb, W, Lmax, fm, eg, out, ea + p, lane); break;
        case 2: sweep_pair<2>(C, xs, ys, lx, ly, nb, W, Lmax, fm, eg, out, ea + p, lane); break;
        case 3: sweep_pair<3>(C, xs, ys, lx, ly, nb, W, Lmax, fm, eg, out, ea + p, lane); break;
        case 4: sweep_pair<4>(C, xs, ys, lx, ly, nb, W, Lmax, fm, eg, out, ea + p, lane); break;
        case 5: sweep_pair<5>(C, xs, ys, lx, ly, nb, W, Lmax, fm, eg, out, ea + p, lane); break;
        default: sweep_pair<6>(C, xs, ys, lx, ly, nb, W, Lmax, fm, eg, out, ea + p, lane); break;
    }
}

}  // namespace

// Pair p reads row ia[p] of (xc, lx) and row ib[p] of (yc, ly); with ia
// and ib null, row p of each. fm_stride: f32 elements of forward-M scratch
// per pair, from pairhmm_cuda.kernel_layout; edge may be null when
// Lmax + 1 <= 32 * RMAX.
extern "C" int pairhmm_launch(
    const void* xc, const void* yc, const void* lx, const void* ly, const void* ia, const void* ib,
    const void* consts, void* fwdm, void* edge, void* post, void* ea, int P, int Lmax,
    long long fm_stride, void* stream)
{
    if (P == 0) return 0;
    const int SL = (Lmax + 2 + 3) & ~3;
    const size_t smem = (size_t)WARPS * 2 * SL;
    const int blocks = (P + WARPS - 1) / WARPS;
    pairhmm_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const int8_t*)xc, (const int8_t*)yc, (const int32_t*)lx, (const int32_t*)ly,
        (const int32_t*)ia, (const int32_t*)ib, (const float*)consts, (float*)fwdm, (float*)edge, (float*)post, (float*)ea, P, Lmax, fm_stride);
    return (int)cudaGetLastError();
}
