// The merge of the device MSA's batched profile alignment: BuildPost (the
// profile-profile posterior), the MEA max-DP over it and the traceback —
// MUSCLE v5's BuildPost + CalcAlnFlat + TraceBackFlat. The Hopper kernel
// that replaces the XLA program _build_post -> _mea_forward -> _walk of
// dna_ldpc_tpu/ops/msa/device_msa.py (:175, :212, :257; one-hot matmuls
// and two scans there, not a Pallas kernel).
//
// One entry, merge_dp: it reads its operand straight from the batch's
// assembled pair tensor (bf16 [C, npair, L + 1, L + 1], pairs s1 < s2 in
// cluster_pairs(nb) order, a zero gap row and column at L), sweeps the DP,
// packs the choice plane and walks it back. The pair of members (s1, s2)
// is read at its slot, as stored where s1 < s2 and transposed where
// s1 > s2; a member met on both sides would add its zero diagonal block,
// so it is skipped.
//
// What bounds the work on the card: the DP is a chain of wA + wB dependent
// antidiagonals of ~4 operations per cell, and the operand is |A| x |B|
// two-byte loads per cell (one when both sides are single reads); the
// bytes that must move are the |A| x |B| pair blocks, once. The old
// kernel was held back by what it did around that work (a block barrier
// per diagonal of the whole (Cmax + 1)^2 plane, one sector per 4-byte
// operand, a byte per choice code, and an operand plane of Cmax^2 f32 per
// cluster that BuildPost wrote to device memory with 4 nb launches just
// before). The design:
//
// - One warp per cluster, no block barrier, up to 64 members: each side's
//   membership is one 64-bit mask, two ballots (members 0-31 and 32-63).
//   Only the box [0..wA] x [0..wB] is swept: the walk starts at (wA, wB)
//   and moves to smaller i and j only, and a cell of the box depends on
//   cells of the box only. Diagonals the path does not visit are written
//   as code 0, position 0.
// - Lane l owns the strip of R = ceil((wB + 1) / 32) columns
//   j = l R .. l R + R - 1 and walks down the rows as a wavefront: at step
//   t it computes row i = t - l. The previous row of its strip stays in
//   registers; the one value it needs from its left neighbour per row
//   (S(i, l R - 1), and the same of the row before) comes by
//   __shfl_up_sync. R is a template parameter (1..9, Cmax <= 287), so a
//   step is one straight block of R cells. Within a step the only chain
//   is one fmaxf per cell: max(B, X) is known from the previous row.
// - Operands do not depend on the DP, so a lane fetches them for a chunk
//   of steps at once (about CHUNK_CELLS = 64 cells: 12 steps at R = 5)
//   into registers, the loops over the members outermost: one memory
//   latency per pair of members and chunk, with every cell's load in
//   flight together, where a fetch per step paid it per pair of members
//   and step. A lane's R operands of a row share a 32-byte sector of a
//   stored block (s1 < s2); in a transposed one its CH rows of a column do.
// - merge_dp resolves the letter position u of every member of A and B at
//   each of its profile columns once per cluster into uint16 tables in
//   shared memory, then per cell sums the pair posterior of
//   (u(s1, i-1), u(s2, j-1)) over the members of A in ascending order in
//   f32, rounds to bf16, and sums over the members of B in ascending order
//   in f32: the twin's sums without its zero terms (the values are
//   non-negative, so the sums are equal bit for bit). Neither post
//   [C, Cmax, Cmax] nor the first sum T [C, Cmax, nb (L + 1)] exists in
//   device memory.
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
constexpr int MAX_MEMBERS = 64;  // sequences a cluster: two ballots of a warp
// wavefront steps per operand fetch of a lane that owns R columns
__host__ __device__ constexpr int chunk_steps(int R) { return CHUNK_CELLS / R < 2 ? 2 : CHUNK_CELLS / R > 16 ? 16 : CHUNK_CELLS / R; }
constexpr unsigned FULL = 0xffffffffu;

// one lane's R two-bit codes of a step
template <int R>
using strip_word = std::conditional_t<(R <= 4), uint8_t, std::conditional_t<(R <= 8), uint16_t, uint32_t>>;

constexpr int word_bytes(int R) { return R <= 4 ? 1 : R <= 8 ? 2 : 4; }

__device__ __forceinline__ int slot_of(int i, int j, int nb) {  // pair i < j in cluster_pairs(nb) order
    return i * nb - i * (i + 1) / 2 + (j - i - 1);
}

// Operand source of merge_dp: BuildPost from the cluster's pair tensor.
// rowtab[s][i] is the letter position of sequence s of A at cell row i (L,
// the zero gap row, for i = 0, a gap, or past the table's real entries),
// coltab[s][j] that of sequence s of B.
struct PairSource {
    const uint16_t* pb;      // the cluster's pairs as bf16 bit patterns, [npair, L1, L1]
    const uint16_t* rowtab;  // [nb][TL], shared memory
    const uint16_t* coltab;  // [nb][TL]
    int L1, TL, nb, wa;
    uint64_t maskA, maskB;

    // BuildPost of cells (i0 + p, j0 + r), p < CH, r < R. A row off the
    // box reads table entry 0, the zero gap row: its operands are 0.
    template <int R, int CH>
    __device__ __forceinline__ void fetch(int i0, int j0, float (&op)[CH][R]) const {
        const int blk = L1 * L1;
        int row[CH];
#pragma unroll
        for (int p = 0; p < CH; ++p) {
            row[p] = (i0 + p >= 1 && i0 + p <= wa) ? i0 + p : 0;
#pragma unroll
            for (int r = 0; r < R; ++r) op[p][r] = 0.0f;
        }
        for (uint64_t mb = maskB; mb; mb &= mb - 1) {
            const int s2 = __ffsll(mb) - 1;
            const uint16_t* ct = coltab + s2 * TL + j0;
            int col[R];
            float first[CH][R];
#pragma unroll
            for (int r = 0; r < R; ++r) col[r] = ct[r];
#pragma unroll
            for (int p = 0; p < CH; ++p)
#pragma unroll
                for (int r = 0; r < R; ++r) first[p][r] = 0.0f;
            // members of A in ascending order: below s2 the pair (s1, s2) as
            // stored (row u1, column u2), above it (s2, s1) transposed
            for (uint64_t ma = maskA & ((1ull << s2) - 1); ma; ma &= ma - 1) {
                const int s1 = __ffsll(ma) - 1;
                const uint16_t* pp = pb + (size_t)slot_of(s1, s2, nb) * blk;
                const uint16_t* rt = rowtab + s1 * TL;
#pragma unroll
                for (int p = 0; p < CH; ++p) {
                    const uint16_t* pr = pp + (int)rt[row[p]] * L1;
#pragma unroll
                    for (int r = 0; r < R; ++r)
                        first[p][r] += __uint_as_float((uint32_t)__ldg(pr + col[r]) << 16);
                }
            }
            for (uint64_t ma = maskA & ~((2ull << s2) - 1); ma; ma &= ma - 1) {
                const int s1 = __ffsll(ma) - 1;
                const uint16_t* pp = pb + (size_t)slot_of(s2, s1, nb) * blk;
                const uint16_t* rt = rowtab + s1 * TL;
#pragma unroll
                for (int p = 0; p < CH; ++p) {
                    const uint16_t* pc = pp + (int)rt[row[p]];
#pragma unroll
                    for (int r = 0; r < R; ++r)
                        first[p][r] += __uint_as_float((uint32_t)__ldg(pc + col[r] * L1) << 16);
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
__device__ void sweep_and_walk(const PairSource& src, int wa, int wb, void* plane_raw,
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

__device__ __forceinline__ void sweep_by_strip(const PairSource& src, int wa, int wb, void* plane,
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
    const uint16_t* __restrict__ pairs,    // [C, npair, L + 1, L + 1] bf16
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
    const int L1 = L + 1, CP1 = Cmax + 1, npair = nb * (nb - 1) / 2;
    uint8_t* codes_c = codes + (size_t)c * 2 * Cmax;
    int32_t* pos_c = pos + (size_t)c * 2 * Cmax;
    int wa, wb;
    cluster_setup(wA, wB, codes_c, pos_c, Cmax, wa, wb);

    const uint8_t* mAc = mA + (size_t)c * nb;
    const uint8_t* mBc = mB + (size_t)c * nb;
    const uint64_t maskA = (uint64_t)__ballot_sync(FULL, lane < nb && mAc[lane]) |
                           (uint64_t)__ballot_sync(FULL, lane + 32 < nb && mAc[lane + 32]) << 32;
    const uint64_t maskB = (uint64_t)__ballot_sync(FULL, lane < nb && mBc[lane]) |
                           (uint64_t)__ballot_sync(FULL, lane + 32 < nb && mBc[lane + 32]) << 32;
    for (int side = 0; side < 2; ++side) {
        const int32_t* cpos = (side ? cposB : cposA) + (size_t)c * nb * CP1;
        uint16_t* tab = side ? coltab : rowtab;
        for (uint64_t m = side ? maskB : maskA; m; m &= m - 1) {
            const int s = __ffsll(m) - 1;
            for (int k = lane; k < TL; k += 32) {
                const int u = (k >= 1 && k <= Cmax) ? min(max(cpos[s * CP1 + k - 1], 0), L) : L;
                tab[s * TL + k] = (uint16_t)u;
            }
        }
    }
    __syncwarp();

    const PairSource src{pairs + (size_t)c * npair * L1 * L1, rowtab, coltab, L1, TL, nb, wa, maskA, maskB};
    sweep_by_strip(src, wa, wb, smem, codes_c, pos_c);
}

// Shared memory of one cluster's warp: the packed plane, (Cmax + 32) steps
// x 32 lanes of the widest strip's word (two uint16 tables of letter
// positions, nb x 32 strips entries each, follow it: 57 KB at nb = 64 and
// Cmax = 192). -1: Cmax is beyond the kernel.
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

extern "C" int merge_dp_launch(const void* pairs, const void* cposA, const void* cposB, const void* mA,
                               const void* mB, const void* wA, const void* wB, void* codes, void* pos,
                               int C, int nb, int L, int Cmax, void* stream)
{
    if (C == 0) return 0;
    const int plane_bytes = plane_bytes_of(Cmax);
    if (plane_bytes < 0 || nb < 1 || nb > MAX_MEMBERS || L < 1 || L + 1 > 65535) return (int)cudaErrorInvalidValue;
    const int TL = 32 * (Cmax / 32 + 1);
    const size_t smem = (size_t)plane_bytes + (size_t)2 * nb * TL * sizeof(uint16_t);
    const cudaError_t e = allow_smem(merge_dp_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    merge_dp_kernel<<<C, 32, smem, (cudaStream_t)stream>>>(
        (const uint16_t*)pairs, (const int32_t*)cposA, (const int32_t*)cposB, (const uint8_t*)mA,
        (const uint8_t*)mB, (const int32_t*)wA, (const int32_t*)wB, (uint8_t*)codes, (int32_t*)pos,
        nb, L, Cmax, plane_bytes, TL);
    return (int)cudaGetLastError();
}
