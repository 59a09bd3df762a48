// The merge of the device MSA's batched profile alignment: BuildPost (the
// profile-profile posterior), the MEA max-DP over it and the traceback —
// MUSCLE v5's BuildPost + CalcAlnFlat + TraceBackFlat. The Hopper kernel
// that replaces the XLA program _build_post -> _mea_forward -> _walk of
// dna_ldpc_tpu/ops/msa/device_msa.py (:175, :212, :257; one-hot matmuls
// and two scans there, not a Pallas kernel).
//
// One entry, merge_dp: it reads its operand straight from the per-cluster
// block matrix of pair posteriors (Pblock, bf16), sweeps the DP, packs the
// choice plane and walks it back.
//
// What bounds the work on the card: the DP is a chain of wA + wB dependent
// antidiagonals of ~4 operations per cell, and the operand is |A| x |B|
// two-byte loads per cell (one when both sides are single reads); the
// bytes that must move are the |A| x |B| blocks of Pblock, once. The old
// kernel was held back by what it did around that work (a block barrier
// per diagonal of the whole (Cmax + 1)^2 plane, one sector per 4-byte
// operand, a byte per choice code, and an operand plane of Cmax^2 f32 per
// cluster that BuildPost wrote to device memory with 4 nb launches just
// before). The design:
//
// - One warp per cluster, no block barrier. Only the box
//   [0..wA] x [0..wB] is swept: the walk starts at (wA, wB) and moves to
//   smaller i and j only, and a cell of the box depends on cells of the
//   box only. Diagonals the path does not visit are written as code 0,
//   position 0.
// - Lane l owns the strip of R = ceil((wB + 1) / 32) columns
//   j = l R .. l R + R - 1 and walks down the rows as a wavefront: at step
//   t it computes row i = t - l. The previous row of its strip stays in
//   registers; the one value it needs from its left neighbour per row
//   (S(i, l R - 1), and the same of the row before) comes by
//   __shfl_up_sync. R is a template parameter (1..9, Cmax <= 287), so a
//   step is one straight block of R cells. Within a step the only chain
//   is one fmaxf per cell: max(B, X) is known from the previous row.
// - Columns, not rows, are the strip: the operand is contiguous along j,
//   so a lane's R operands of a row share one 32-byte sector of the bf16
//   block. Operands do not depend on the DP, so a lane fetches them for a
//   chunk of steps at once (about
//   CHUNK_CELLS = 64 cells: 12 steps at R = 5) into registers, the loops
//   over the members outermost: one memory latency per pair of members
//   and chunk, with every cell's load in flight together, where a fetch
//   per step paid it per pair of members and step.
// - merge_dp resolves row(s, .) and col(s, .) of every member of A and B
//   once per cluster into uint16 tables in shared memory, then per cell
//   sums Pblock[row(s1, i-1), col(s2, j-1)] over the members of A in
//   ascending order in f32, rounds to bf16, and sums over the members of B
//   in ascending order in f32: the twin's sums without its zero terms (the
//   values are non-negative, so the sums are equal bit for bit). Neither
//   post [C, Cmax, Cmax] nor the first sum T [C, Cmax, nb (L + 1)] exists
//   in device memory.
// - The choice codes take two bits. A lane's strip of a step is one
//   uint8/uint16/uint32 (R <= 4 / 8 / 9) at plane[t][lane]: 14 KB of
//   shared memory per cluster at Cmax = 192 (the byte plane took 74 KB),
//   conflict-free. Lane 0 walks it back: cell (i, j) is bits 2 (j mod R)
//   of plane[i + j / R][j / R].
//
// Semantics kept bit for bit with the plain twin
// (ops/msa/mea_cuda.py::merge_walk_ref = _build_post + mea_walk_ref) and
// the JAX scans: f32 values, the tie order B >= X >= Y, the boundary
// codes (i == 0 -> Y, j == 0 -> X, value 0). The twin's NEG cells (j < 0)
// and code-0 cells lie outside the box and are never reached from inside
// it. A cell's value is the largest of B, X, Y whichever the tie order
// picks, so fmaxf gives the twin's value (up to the sign of a zero, which
// no comparison or sum sees).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK_CELLS = 64;  // cells of a lane whose operands are fetched together
constexpr int CB = 1, CX = 2, CY = 3;
constexpr int RMAX = 9;  // columns per lane: Cmax + 1 <= 32 RMAX
// wavefront steps per operand fetch of a lane that owns R columns
__host__ __device__ constexpr int chunk_steps(int R) { return CHUNK_CELLS / R < 2 ? 2 : CHUNK_CELLS / R > 16 ? 16 : CHUNK_CELLS / R; }
constexpr unsigned FULL = 0xffffffffu;

// one lane's R two-bit codes of a step
template <int R>
using strip_word = std::conditional_t<(R <= 4), uint8_t, std::conditional_t<(R <= 8), uint16_t, uint32_t>>;

constexpr int word_bytes(int R) { return R <= 4 ? 1 : R <= 8 ? 2 : 4; }

// Operand source of merge_dp: BuildPost from the cluster's block matrix.
// rowtab[s][i] is the row of Pblock that sequence s of A contributes to
// cell row i (the zero gap row of its block for i = 0, a gap, or past the
// table's real entries), coltab[s][j] the column of sequence s of B.
struct BlockSource {
    const uint16_t* pb;      // Pblock[c] as bf16 bit patterns, [K, K]
    const uint16_t* rowtab;  // [nb][TL], shared memory
    const uint16_t* coltab;  // [nb][TL]
    int K, TL, wa;
    uint32_t maskA, maskB;

    // BuildPost of cells (i0 + p, j0 + r), p < CH, r < R. A row off the
    // box reads table entry 0, the zero gap row: its operands are 0.
    template <int R, int CH>
    __device__ __forceinline__ void fetch(int i0, int j0, float (&op)[CH][R]) const {
        int row[CH];
#pragma unroll
        for (int p = 0; p < CH; ++p) {
            row[p] = (i0 + p >= 1 && i0 + p <= wa) ? i0 + p : 0;
#pragma unroll
            for (int r = 0; r < R; ++r) op[p][r] = 0.0f;
        }
        for (uint32_t mb = maskB; mb; mb &= mb - 1) {
            const uint16_t* ct = coltab + (__ffs(mb) - 1) * TL + j0;
            int col[R];
            float first[CH][R];
#pragma unroll
            for (int r = 0; r < R; ++r) col[r] = ct[r];
#pragma unroll
            for (int p = 0; p < CH; ++p)
#pragma unroll
                for (int r = 0; r < R; ++r) first[p][r] = 0.0f;
            for (uint32_t ma = maskA; ma; ma &= ma - 1) {
                const uint16_t* rt = rowtab + (__ffs(ma) - 1) * TL;
#pragma unroll
                for (int p = 0; p < CH; ++p) {
                    const uint16_t* pr = pb + (uint32_t)rt[row[p]] * (uint32_t)K;
#pragma unroll
                    for (int r = 0; r < R; ++r)
                        first[p][r] += __uint_as_float((uint32_t)__ldg(pr + col[r]) << 16);
                }
            }
#pragma unroll
            for (int p = 0; p < CH; ++p)
#pragma unroll
                for (int r = 0; r < R; ++r) op[p][r] += __bfloat162float(__float2bfloat16_rn(first[p][r]));
        }
    }
};

// The box sweep and the walk of one cluster by one warp (file comment).
// plane: (wa + 32) x 32 words of shared memory at least.
template <int R>
__device__ void sweep_and_walk(const BlockSource& src, int wa, int wb, void* plane_raw,
                               uint8_t* codes, int32_t* pos)
{
    using word = strip_word<R>;
    word* plane = reinterpret_cast<word*>(plane_raw);
    const int lane = threadIdx.x & 31;
    const int j0 = lane * R;
    const int nl = wb / R + 1;      // lanes that own a column of the box
    const bool owner = lane < nl;
    const int steps = wa + nl;      // lane l computes row t - l at step t

    float prev[R];                  // S(i - 1, j0 + r)
#pragma unroll
    for (int r = 0; r < R; ++r) prev[r] = 0.0f;
    float last = 0.0f;              // S(i, j0 + R - 1) of the row just computed
    float left_cur = 0.0f, left_prev = 0.0f;  // S(i, j0 - 1), S(i - 1, j0 - 1)

    constexpr int CH = chunk_steps(R);
    for (int t0 = 0; t0 < steps; t0 += CH) {
        float op[CH][R];
        if (owner) src.fetch<R, CH>(t0 - lane, j0, op);
#pragma unroll
        for (int p = 0; p < CH; ++p) {
            const int t = t0 + p, i = t - lane;
            const float up = __shfl_up_sync(FULL, last, 1);
            left_prev = left_cur;
            left_cur = up;
            if (owner && i >= 0 && i <= wa) {
                uint32_t w = 0;
                if (i == 0) {
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        prev[r] = 0.0f;
                        w |= (uint32_t)CY << (2 * r);
                    }
                    last = 0.0f;
                } else {
                    float diag = left_prev, left = left_cur;
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float pX = prev[r], pB = diag + op[p][r], pY = left;
                        const bool bx = pB >= pX, by = pB >= pY, xy = pX >= pY;
                        float val = fmaxf(fmaxf(pB, pX), pY);
                        uint32_t code = bx ? (by ? CB : CY) : (xy ? CX : CY);
                        if (r == 0 && lane == 0) {  // column j = 0
                            val = 0.0f;
                            code = CX;
                        }
                        diag = pX;
                        left = val;
                        prev[r] = val;
                        w |= code << (2 * r);
                    }
                    last = left;
                }
                plane[t * 32 + lane] = (word)w;
            }
        }
    }
    __syncwarp();

    if (lane == 0) {
        int ic = wa, jc = wb;
        while (ic + jc > 0) {
            const int l = jc / R, r = jc - l * R;
            const int code = ((uint32_t)plane[(ic + l) * 32 + l] >> (2 * r)) & 3;
            const int d = ic + jc;
            codes[d - 1] = (uint8_t)code;
            pos[d - 1] = ic;
            if (code == CB) {
                --ic;
                --jc;
            } else if (code == CX) {
                --ic;
            } else {
                --jc;
            }
        }
    }
}

__device__ __forceinline__ void sweep_by_strip(const BlockSource& src, int wa, int wb, void* plane,
                                               uint8_t* codes, int32_t* pos)
{
    static_assert(RMAX == 9, "one case per strip width");
    switch (wb / 32 + 1) {
        case 1: sweep_and_walk<1>(src, wa, wb, plane, codes, pos); break;
        case 2: sweep_and_walk<2>(src, wa, wb, plane, codes, pos); break;
        case 3: sweep_and_walk<3>(src, wa, wb, plane, codes, pos); break;
        case 4: sweep_and_walk<4>(src, wa, wb, plane, codes, pos); break;
        case 5: sweep_and_walk<5>(src, wa, wb, plane, codes, pos); break;
        case 6: sweep_and_walk<6>(src, wa, wb, plane, codes, pos); break;
        case 7: sweep_and_walk<7>(src, wa, wb, plane, codes, pos); break;
        case 8: sweep_and_walk<8>(src, wa, wb, plane, codes, pos); break;
        default: sweep_and_walk<9>(src, wa, wb, plane, codes, pos); break;
    }
}

// The cluster's widths (held to 0..Cmax), and its output rows zeroed: the
// walk writes only the diagonals it visits, after a __syncwarp.
__device__ __forceinline__ void cluster_setup(const int32_t* wA, const int32_t* wB, uint8_t* codes_c,
                                              int32_t* pos_c, int Cmax, int& wa, int& wb)
{
    wa = min(max(wA[blockIdx.x], 0), Cmax);
    wb = min(max(wB[blockIdx.x], 0), Cmax);
    for (int k = threadIdx.x; k < 2 * Cmax; k += 32) {
        codes_c[k] = 0;
        pos_c[k] = 0;
    }
}

__global__ void __launch_bounds__(32) merge_dp_kernel(
    const uint16_t* __restrict__ Pblock,   // [C, K, K] bf16, K = nb (L + 1)
    const int32_t* __restrict__ cposA,     // [C, nb, Cmax + 1]
    const int32_t* __restrict__ cposB,
    const uint8_t* __restrict__ mA,        // [C, nb] bool
    const uint8_t* __restrict__ mB,
    const int32_t* __restrict__ wA, const int32_t* __restrict__ wB,
    uint8_t* __restrict__ codes, int32_t* __restrict__ pos,
    int nb, int L, int Cmax, int plane_bytes, int TL)
{
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* rowtab = reinterpret_cast<uint16_t*>(smem + plane_bytes);
    uint16_t* coltab = rowtab + nb * TL;
    const int c = blockIdx.x, lane = threadIdx.x;
    const int L1 = L + 1, K = nb * L1, CP1 = Cmax + 1;
    uint8_t* codes_c = codes + (size_t)c * 2 * Cmax;
    int32_t* pos_c = pos + (size_t)c * 2 * Cmax;
    int wa, wb;
    cluster_setup(wA, wB, codes_c, pos_c, Cmax, wa, wb);

    const uint32_t maskA = __ballot_sync(FULL, lane < nb && mA[(size_t)c * nb + lane]);
    const uint32_t maskB = __ballot_sync(FULL, lane < nb && mB[(size_t)c * nb + lane]);
    for (int side = 0; side < 2; ++side) {
        const int32_t* cpos = (side ? cposB : cposA) + (size_t)c * nb * CP1;
        uint16_t* tab = side ? coltab : rowtab;
        for (uint32_t m = side ? maskB : maskA; m; m &= m - 1) {
            const int s = __ffs(m) - 1;
            for (int k = lane; k < TL; k += 32) {
                const int u = (k >= 1 && k <= Cmax) ? min(max(cpos[s * CP1 + k - 1], 0), L) : L;
                tab[s * TL + k] = (uint16_t)(s * L1 + u);
            }
        }
    }
    __syncwarp();

    const BlockSource src{Pblock + (size_t)c * K * K, rowtab, coltab, K, TL, wa, maskA, maskB};
    sweep_by_strip(src, wa, wb, smem, codes_c, pos_c);
}

// Shared memory of one cluster's warp: the packed plane, (Cmax + 32) steps
// x 32 lanes of the widest strip's word (two uint16 index tables of nb x 32
// strips entries follow it). -1: Cmax is beyond the kernel.
int plane_bytes_of(int Cmax)
{
    const int R = Cmax / 32 + 1;
    return (Cmax < 1 || R > RMAX) ? -1 : (Cmax + 32) * 32 * word_bytes(R);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem)
{
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int merge_dp_launch(const void* Pblock, const void* cposA, const void* cposB, const void* mA,
                               const void* mB, const void* wA, const void* wB, void* codes, void* pos,
                               int C, int nb, int L, int Cmax, void* stream)
{
    if (C == 0) return 0;
    const int plane_bytes = plane_bytes_of(Cmax);
    if (plane_bytes < 0 || nb < 1 || nb > 32 || (long long)nb * (L + 1) > 65535) return (int)cudaErrorInvalidValue;
    const int TL = 32 * (Cmax / 32 + 1);
    const size_t smem = (size_t)plane_bytes + (size_t)2 * nb * TL * sizeof(uint16_t);
    const cudaError_t e = allow_smem(merge_dp_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    merge_dp_kernel<<<C, 32, smem, (cudaStream_t)stream>>>(
        (const uint16_t*)Pblock, (const int32_t*)cposA, (const int32_t*)cposB, (const uint8_t*)mA,
        (const uint8_t*)mB, (const int32_t*)wA, (const int32_t*)wB, (uint8_t*)codes, (int32_t*)pos,
        nb, L, Cmax, plane_bytes, TL);
    return (int)cudaGetLastError();
}
