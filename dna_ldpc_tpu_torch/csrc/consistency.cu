// The consistency transform of the MSA (MUSCLE's consflat.cpp:5-23 and
// relaxflat.cpp:4-91), one launch per iteration.
//
// It replaces no Pallas kernel: the JAX package leaves this product to XLA
// (dna_ldpc_tpu/ops/msa/consistency.py, a batched einsum over a block
// tensor of every ordered pair), and the port first ran it as a full-f32
// torch.bmm over the same bucket-padded block tensor. That product spends
// most of its work on padding: the bucket's pad members, the zero diagonal
// blocks (z = i and z = j), the lower triangle the caller throws away and
// the rows and columns past each read's true length. This kernel does only
// the true work. For every cluster c of the batch, every pair i < j of its
// members and every entry (a, b) of the pair's true box L_i x L_j:
//
//   out_ij[a, b] = A_ij[a, b] < 0.01 ? 0
//                : (2 A_ij[a, b] + sum_{z != i, j} sum_{k < L_z} A_iz[a, k] A_zj[k, b]) * inv_n[c]
//
// where A_iz is read as the stored A_zi transposed when z < i, and A_zj as
// A_jz transposed when z > j. Members and lengths come from `lengths`
// [C, nb] (0 marks a pad member, never read); the grid is the host's work
// list of output tiles, (c, i | j << 16, ti | tj << 16), cluster-major so
// that one cluster's pairs stay in L2 while its blocks run.
//
// What bounds it: float32 FMA on the CUDA cores (the configuration states
// the products in float32 with TF32 off; 67 TFLOP/s on an H100 SXM). Each
// output entry is a dot product of sum_z L_z terms, and every input pair is
// read by n - 2 output pairs, so the bytes are far below the FLOPs. The
// design keeps the FMA pipes, not shared memory, the limit: one block of
// 256 threads per 160 x 160 output tile, each thread a 10 x 10 register tile
// (100 accumulators; per k step 10 eight-byte shared loads feed 100 FFMA);
// the k dimension walks the other members z ascending in slabs of 16
// positions, the loads masked at L_z (and at the box's edge), staged through
// registers into a double buffer in shared memory so that slab s + 1's
// global loads are in flight while slab s is multiplied, and transposed on
// the way in where the stored pair is the operand's transpose. A full slab
// is one unrolled run of 16 steps; the last slab of each z stops at L_z. No atomics, no split-K: each output is
// one thread's float32 FMA chain in a fixed order (z ascending, then k), so
// two runs are bit-equal. Round one reads the bf16 posteriors through the
// caller's pair ids (the gather, pad mask and casts folded into its loads);
// later rounds read the float32 iterate; the last writes f32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 160;                      // output tile edge
constexpr int THREADS = 256;                   // 16 x 16 threads
constexpr int TT = TILE / 16;                  // each thread's rows and columns: 10
constexpr int KS = 16;                         // k-slab
constexpr int SROW = TILE + 2;                 // shared row: transposed stores conflict-free
constexpr int PER_THREAD = KS * TILE / THREADS;  // slab elements each thread stages: 10
constexpr float MIN_PROB = 0.01f;              // MIN_SPARSE_PROB

static_assert(KS * TILE % THREADS == 0, "a slab must split evenly over the threads");

// A value's bits as loaded, and as a float32. The slabs are staged as raw
// bits: a conversion right after a load would make the warp wait for the
// load there, before the multiply it is meant to overlap.
__device__ __forceinline__ unsigned load_raw(const float* p) { return __float_as_uint(__ldg(p)); }
__device__ __forceinline__ unsigned load_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
}
template <typename T>
__device__ __forceinline__ float from_raw(unsigned r) {
    return __uint_as_float(sizeof(T) == 2 ? r << 16 : r);
}
template <typename T>
__device__ __forceinline__ float load_val(const T* p) { return from_raw<T>(load_raw(p)); }
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int slot_of(int i, int j, int nb) {  // pair i < j in cluster_pairs(nb) order
    return i * nb - i * (i + 1) / 2 + (j - i - 1);
}

// One operand slab: element (k, x), k < nk, x < nx, lies at p[k * rs + x]
// (kmajor) or at p[x * rs + k]; outside those bounds it is 0.
template <typename T>
struct Slab {
    const T* p;
    int rs, nk, nx;
    bool kmajor;
};

template <typename T>
__device__ __forceinline__ void fetch(const Slab<T>& s, unsigned (&r)[PER_THREAD]) {
    const int t = threadIdx.x;
    if (s.kmajor) {  // lanes along x: coalesced rows
#pragma unroll
        for (int m = 0; m < PER_THREAD; ++m) {
            const int e = t + THREADS * m, k = e / TILE, x = e - k * TILE;
            r[m] = (k < s.nk && x < s.nx) ? load_raw(s.p + k * s.rs + x) : 0u;
        }
    } else {  // lanes along k
#pragma unroll
        for (int m = 0; m < PER_THREAD; ++m) {
            const int e = t + THREADS * m, k = e % KS, x = e / KS;
            r[m] = (k < s.nk && x < s.nx) ? load_raw(s.p + x * s.rs + k) : 0u;
        }
    }
}

template <typename T>
__device__ __forceinline__ void stash(float (*sm)[SROW], bool kmajor, const unsigned (&r)[PER_THREAD]) {
    const int t = threadIdx.x;
    if (kmajor) {
#pragma unroll
        for (int m = 0; m < PER_THREAD; ++m) {
            const int e = t + THREADS * m, k = e / TILE;
            sm[k][e - k * TILE] = from_raw<T>(r[m]);
        }
    } else {
#pragma unroll
        for (int m = 0; m < PER_THREAD; ++m) {
            const int e = t + THREADS * m;
            sm[e % KS][e / KS] = from_raw<T>(r[m]);
        }
    }
}

__device__ __forceinline__ void step(float (*sa)[SROW], float (*sb)[SROW], int k, int ty, int tx,
                                     float (&acc)[TT][TT]) {
    float a[TT], b[TT];
#pragma unroll
    for (int r = 0; r < TT; r += 2) {
        const float2 va = *reinterpret_cast<const float2*>(&sa[k][ty * TT + r]);
        const float2 vb = *reinterpret_cast<const float2*>(&sb[k][tx * TT + r]);
        a[r] = va.x;
        a[r + 1] = va.y;
        b[r] = vb.x;
        b[r + 1] = vb.y;
    }
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int s = 0; s < TT; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS, 1)
consistency_kernel(const Tin* __restrict__ src, const long long* __restrict__ src_ids, long long src_pair,
                   int src_row, Tout* __restrict__ dst, long long dst_pair, int dst_row,
                   const int* __restrict__ lengths, const int* __restrict__ work, const float* __restrict__ inv_n,
                   int nb) {
    __shared__ __align__(16) float sa[2][KS][SROW];
    __shared__ __align__(16) float sb[2][KS][SROW];

    const int* w = work + 3 * static_cast<long long>(blockIdx.x);
    const int c = w[0], i = w[1] & 0xffff, j = w[1] >> 16;
    const int row0 = (w[2] & 0xffff) * TILE, col0 = (w[2] >> 16) * TILE;
    const int* len = lengths + static_cast<long long>(c) * nb;
    const int mi = min(TILE, len[i] - row0), nj = min(TILE, len[j] - col0);
    const long long cpair = static_cast<long long>(c) * (nb * (nb - 1) / 2);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

    auto pair = [&](int a, int b) -> const Tin* {  // the stored pair (a, b), a < b
        const long long q = cpair + slot_of(a, b, nb);
        return src + (src_ids ? src_ids[q] : q) * src_pair;
    };
    auto next_z = [&](int z) {
        do {
            ++z;
        } while (z < nb && (z == i || z == j || len[z] <= 0));
        return z;
    };
    // the A (rows of i) and B (columns of j) slabs of member z at k = 0; the
    // pair ids are read here, once per z, and later slabs step along k
    auto first_a = [&](int z) {
        const int nk = min(KS, len[z]);
        return z < i ? Slab<Tin>{pair(z, i) + row0, src_row, nk, mi, true}
                     : Slab<Tin>{pair(i, z) + row0 * src_row, src_row, nk, mi, false};
    };
    auto first_b = [&](int z) {
        const int nk = min(KS, len[z]);
        return z < j ? Slab<Tin>{pair(z, j) + col0, src_row, nk, nj, true}
                     : Slab<Tin>{pair(j, z) + col0 * src_row, src_row, nk, nj, false};
    };
    auto advance = [](Slab<Tin>& sl, int left) {
        sl.p += sl.kmajor ? KS * sl.rs : KS;
        sl.nk = min(KS, left);
    };

    float acc[TT][TT];
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int s = 0; s < TT; ++s) acc[r][s] = 0.f;

    int z = next_z(-1), buf = 0;
    if (z < nb) {
        unsigned ra[PER_THREAD], rb[PER_THREAD];
        int left = len[z];  // positions of z from the current slab on
        Slab<Tin> A = first_a(z), B = first_b(z);
        fetch(A, ra);
        fetch(B, rb);
        stash<Tin>(sa[0], A.kmajor, ra);
        stash<Tin>(sb[0], B.kmajor, rb);
        __syncthreads();
        while (true) {
            const int kn = A.nk;
            left -= KS;
            const int z2 = left > 0 ? z : next_z(z);
            const bool more = z2 < nb;
            if (more) {  // the next slab's loads fly while this one is multiplied
                if (z2 != z) {
                    A = first_a(z2);
                    B = first_b(z2);
                    left = len[z2];
                } else {
                    advance(A, left);
                    advance(B, left);
                }
                fetch(A, ra);
                fetch(B, rb);
            }
            if (kn == KS) {
#pragma unroll
                for (int k = 0; k < KS; ++k) step(sa[buf], sb[buf], k, ty, tx, acc);
            } else {
#pragma unroll 2
                for (int k = 0; k < kn; ++k) step(sa[buf], sb[buf], k, ty, tx, acc);
            }
            if (!more) break;
            stash<Tin>(sa[buf ^ 1], A.kmajor, ra);
            stash<Tin>(sb[buf ^ 1], B.kmajor, rb);
            __syncthreads();
            buf ^= 1;
            z = z2;
        }
    }

    const Tin* pij = pair(i, j);
    Tout* out = dst + (cpair + slot_of(i, j, nb)) * dst_pair;
    const float inv = inv_n[c];
#pragma unroll
    for (int r = 0; r < TT; ++r) {
        const int a = ty * TT + r;
        if (a >= mi) continue;
        const int ga = row0 + a;
#pragma unroll
        for (int s = 0; s < TT; ++s) {
            const int b = tx * TT + s;
            if (b >= nj) continue;
            const int gb = col0 + b;
            const float v = load_val(pij + ga * src_row + gb);
            store_val(out + ga * dst_row + gb, v < MIN_PROB ? 0.f : (2.f * v + acc[r][s]) * inv);
        }
    }
}

template <typename Tin, typename Tout>
int launch(const void* src, const void* src_ids, long long src_pair, int src_row, void* dst, long long dst_pair,
           int dst_row, const void* lengths, const void* work, int n_work, const void* inv_n, int nb,
           cudaStream_t stream) {
    consistency_kernel<Tin, Tout><<<n_work, THREADS, 0, stream>>>(
        static_cast<const Tin*>(src), static_cast<const long long*>(src_ids), src_pair, src_row,
        static_cast<Tout*>(dst), dst_pair, dst_row, static_cast<const int*>(lengths), static_cast<const int*>(work),
        static_cast<const float*>(inv_n), nb);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One round of the transform over the work list (see above). src: f32 pairs
// (src_bf16 = 0) or bf16 posteriors; src_ids: int64 row of each (cluster,
// slot) in src, or null for the slot layout [C, npair, ...]; strides in
// elements. dst: f32 or bf16 in the slot layout; only the true boxes are
// written. Returns cudaGetLastError() after the launch (0: no work).
extern "C" int consistency_launch(const void* src, const void* src_ids, int src_bf16, long long src_pair,
                                  int src_row, void* dst, int dst_bf16, long long dst_pair, int dst_row,
                                  const void* lengths, const void* work, int n_work, const void* inv_n, int nb,
                                  void* stream) {
    if (n_work <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (src_bf16) {
        return dst_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(src, src_ids, src_pair, src_row, dst, dst_pair,
                                                                 dst_row, lengths, work, n_work, inv_n, nb, st)
                        : launch<__nv_bfloat16, float>(src, src_ids, src_pair, src_row, dst, dst_pair, dst_row,
                                                       lengths, work, n_work, inv_n, nb, st);
    }
    return dst_bf16 ? launch<float, __nv_bfloat16>(src, src_ids, src_pair, src_row, dst, dst_pair, dst_row, lengths,
                                                   work, n_work, inv_n, nb, st)
                    : launch<float, float>(src, src_ids, src_pair, src_row, dst, dst_pair, dst_row, lengths, work,
                                           n_work, inv_n, nb, st);
}
