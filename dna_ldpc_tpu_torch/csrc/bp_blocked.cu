// Fused flooding sum-product BP for a permutation-blocked (protograph)
// LDPC code: the Hopper port of the TPU kernel
// dna_ldpc_tpu/ops/bp_pallas.py::_bp_kernel.
//
// What it computes. One thread block decodes one codeword and runs its own
// iteration loop; with early_stop the block exits at its first zero
// syndrome, which gives the same latched bits/unsat/iterations as the TPU
// kernel's 64-codeword chunks (their results also latch per codeword).
// Without it (the TPU kernel's fixed-work mode) every block runs max_iter
// iterations and latches bits, unsat and iterations at its first zero
// syndrome, so both modes return the same words; only the work differs.
// One thread per check of the current coset (q threads). Routing is an
// exact indexed gather/scatter through pi[g, j, r] (the TPU builds a
// one-hot matrix for its matrix unit instead). Within a coset every
// variable receives exactly one edge, so the posterior update needs no
// atomics; cosets are accumulated in order g = 0..G-1 with a barrier
// between them, which keeps the TPU kernel's f32 summation order.
//
// Rounding points kept from the TPU kernel: v0 = bf16(llr); t =
// bf16(tanh(v / 2)); te = f32 forward*backward product of bf16 t, clipped
// to +-te_clip; c2v = bf16(log((1 + te) / (1 - te))); post = llr + sum_g
// c2v in f32; bits = !(post > 0); parity from !(bf16(post) > 0). Both
// sweeps multiply sequentially in f32 (acc = t[j+1] * acc backward,
// F = F * t[j] forward, te = F * bwd[j]). Compiled without fast-math:
// tanhf and logf are the libdevice routines PyTorch's CUDA tanh and log
// use, so the plain torch twin (ops/bp_cuda.py::bp_decode_blocked_ref)
// agrees bit for bit.
//
// Where the data lives. The bf16 tanh-domain messages [G, J, q] of a
// codeword (295 KB for the deployed 8 x 72 x 256 code) stay in one global
// slab that holds t = tanh(v2c / 2) before the check update and c2v after
// it, but no sweep touches global memory: the slab moves coset by coset
// through rings of two shared-memory buffers. On entering a coset the
// threads wait for its tile, start the 16-byte cp.async copies of the next
// tile into the other buffer, work on shared memory and registers alone,
// and store the tile back with 16-byte coalesced writes. The thread that
// reads a slot of a tile is the only one that writes it, so one tile
// serves both phases. The f32 posterior [J q] is in shared memory
// throughout.
//
// Two kernels (chosen by the wrapper's kernel_layout):
//   - bp_unrolled_kernel<J = 72, q = 256>, 2 q = 512 threads: the deployed
//     code. Tiles are check-major ([q][J]: a check's 72 messages are 144
//     contiguous bytes), so a thread reads its row with nine conflict-free
//     16-byte loads, does all its arithmetic in registers with both
//     sweeps fully unrolled (the divisions and logf of different j
//     overlap) and writes the row back with nine stores. The backward
//     products are kept at every eighth j and each group of eight is
//     multiplied out again from its kept value by the same operations, so
//     a thread fits 128 registers and the block 16 warps. The two halves
//     of the block take the even and the odd cosets: phase C and the
//     start are independent per coset; in phase B both halves compute
//     their coset's c2v at once and then add it into the posterior in
//     turn, coset g after coset g - 1, handing over through two named
//     barriers (bar.arrive by the half that is done, bar.sync by the one
//     that waits) — the f32 order of the posterior sum is the sequential
//     one. The posterior is read or updated eight entries at a time, loads
//     before stores (entries of different j never alias). A check's 72 pi
//     bytes come as an 80-byte row straight from global memory (the table
//     is 164 KB, shared by every block). The wrapper renames checks and
//     variables (bank_friendly_form) so that the posterior entries of a
//     warp's 32 checks lie in 32 different banks. Each half has its own
//     ring, ordered by a barrier of the half alone. Shared memory:
//     4 x 36,864 + 73,728 = 221,184 bytes.
//   - bp_generic_kernel, q threads: any J and q, tiles coset-major
//     ([J][q]), backward products in a [J][q] f32 shared buffer. With
//     q <= 256 the coset's message tile and its pi tile (one byte per
//     entry) are staged: shared memory 8 J q + 2 x (tile + pi tile); on
//     the card that ran 1.6-1.7x faster than reading them in place (q = 64
//     and 256), staging the message tile alone 1.2-1.3x, and the width of
//     a pi entry moved nothing. Codes with q > 256 (16 or more warps hide
//     the loads: staging lost 10 % at q = 512) and codes whose tiles do
//     not fit beside the posterior and the backward buffer (8 J q bytes,
//     the wrapper's whole domain) run the same code with the tile pointers
//     aimed at the global slab and the code's own int32 pi table
//     (STAGE = false).
//
// What bounds it on the card: operations, not bytes. Per edge and
// iteration one division, one logf and one tanhf with their bf16
// roundings (4 special-function operations and ~60 SASS operations as
// compiled), 147,456 edges per codeword of the deployed code, one
// codeword per SM; the bytes that must move (LLRs in, bits out) are three
// orders below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src_global) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst_shared);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src_global) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// The unrolled kernel: J and q at compile time, 2 q threads.
// ---------------------------------------------------------------------------

// bf16 element j of a row held as packed 32-bit words (exact: a bf16 is
// the upper half of an f32), and its replacement
__device__ __forceinline__ float row_get(const uint32_t* w, int j) {
    return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
}

__device__ __forceinline__ void row_set(uint32_t* w, int j, __nv_bfloat16 v) {
    const uint32_t b = __bfloat16_as_ushort(v);
    w[j >> 1] = (j & 1) ? ((w[j >> 1] & 0x0000ffffu) | (b << 16)) : ((w[j >> 1] & 0xffff0000u) | b);
}

__device__ __forceinline__ int pi_get(const uint32_t* w, int j) { return (int)((w[j >> 2] >> (8 * (j & 3))) & 0xffu); }

// Named barriers 1 and 2 hand the posterior from one half of the block to
// the other: the half that has scattered arrives and goes on, the half
// whose coset is next waits. Both count all 2 q threads.
__device__ __forceinline__ void turn_pass(int id, int threads) {
    __threadfence_block();
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void turn_wait(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int JT, int QT>
__global__ void __launch_bounds__(2 * QT, 1) bp_unrolled_kernel(
    const float* __restrict__ llr_c,        // [B, J*q] kernel order, sanitized
    const unsigned char* __restrict__ pi,   // [G, q, PROW] one byte per entry, check-major
    __nv_bfloat16* __restrict__ msg,        // [B, G, q, J] scratch, check-major
    uint8_t* __restrict__ bits_c,           // [B, J*q] kernel order (out)
    int32_t* __restrict__ unsat_out,        // [B]
    int32_t* __restrict__ iters_out,        // [B]
    int G, int max_iter, int early_stop, float te_clip)
{
    constexpr int N = JT * QT, MW = JT / 2, PROW = (JT + 15) / 16 * 16, PW = PROW / 4, NG = JT / 8;
    static_assert(JT % 8 == 0 && QT % 32 == 0 && QT <= 256, "rows of whole 16-byte words, one-byte pi");
    // shared memory: [2 halves][2 buffers][q][J] bf16 message tiles, then the f32 posterior [J*q]
    constexpr int TILE_BYTES = 2 * N;
    extern __shared__ __align__(16) unsigned char smem[];
    float* post = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
    __shared__ int s_unsat;
    const int b = blockIdx.x;
    const int half = threadIdx.x / QT;  // cosets g = half, half + 2, ...
    const int r = threadIdx.x % QT;     // my check in each of them
    const float* llr = llr_c + (size_t)b * N;
    __nv_bfloat16* m = msg + (size_t)b * G * N;
    uint8_t* bits = bits_c + (size_t)b * N;

    // ---- my half's ring of two tile buffers --------------------------------
    // Only my half touches the tiles of my cosets, in shared memory and in
    // the slab, so a barrier of the half's q threads (ids 3 and 4) orders
    // everything about them.
    unsigned char* ring = smem + half * 2 * TILE_BYTES;
    const int my_cosets = (G - half + 1) / 2;
    int visit = 0;            // visits so far; visit v uses buffer v & 1
    bool prefetched = false;  // the current visit's tile is already on its way
    __nv_bfloat16* tile = nullptr;
    auto half_sync = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(3 + half), "r"(QT) : "memory"); };
    auto load_tile = [&](int g, int slot) {
        unsigned char* dst = ring + slot * TILE_BYTES;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(m + (size_t)g * N);
        for (int k = r; k < TILE_BYTES / 16; k += QT) cp_async16(dst + 16 * k, src + 16 * k);
        cp_async_commit();
    };
    // Enter coset g: its tile is in shared memory when this returns, and my
    // next coset's tile (this phase's, or the next phase's first) is on its
    // way into the other buffer.
    auto begin_visit = [&](int g) {
        const int slot = visit & 1;
        if (!prefetched) {
            half_sync();  // the tile's last store came from other threads of the half
            load_tile(g, slot);
        }
        cp_async_wait_all();
        half_sync();
        prefetched = my_cosets > 1;
        if (prefetched) load_tile(g + 2 < G ? g + 2 : half, slot ^ 1);
        tile = reinterpret_cast<__nv_bfloat16*>(ring + slot * TILE_BYTES);
    };
    // Leave coset g: the tile goes back to the slab, 16 coalesced bytes a thread.
    auto end_visit = [&](int g) {
        half_sync();
        const uint4* src = reinterpret_cast<const uint4*>(ring + (visit & 1) * TILE_BYTES);
        uint4* dst = reinterpret_cast<uint4*>(m + (size_t)g * N);
        for (int k = r; k < TILE_BYTES / 16; k += QT) dst[k] = src[k];
        ++visit;
    };

    // my check's row of the current tile <-> registers: 16-byte accesses 144 bytes apart, conflict-free
    auto load_row = [&](uint32_t* mw) {
        const uint4* row = reinterpret_cast<const uint4*>(tile + r * JT);
#pragma unroll
        for (int k = 0; k < MW / 4; ++k) {
            const uint4 v = row[k];
            mw[4 * k] = v.x; mw[4 * k + 1] = v.y; mw[4 * k + 2] = v.z; mw[4 * k + 3] = v.w;
        }
    };
    auto store_row = [&](const uint32_t* mw) {
        uint4* row = reinterpret_cast<uint4*>(tile + r * JT);
#pragma unroll
        for (int k = 0; k < MW / 4; ++k) row[k] = make_uint4(mw[4 * k], mw[4 * k + 1], mw[4 * k + 2], mw[4 * k + 3]);
    };
    auto load_pi = [&](int g, uint32_t* pw) {
        const uint4* row = reinterpret_cast<const uint4*>(pi + ((size_t)g * QT + r) * PROW);
#pragma unroll
        for (int k = 0; k < PW / 4; ++k) {
            const uint4 v = __ldg(row + k);
            pw[4 * k] = v.x; pw[4 * k + 1] = v.y; pw[4 * k + 2] = v.z; pw[4 * k + 3] = v.w;
        }
    };
    // sum of every thread's count, the same value in every thread
    auto block_sum = [&](int mine) {
        if (threadIdx.x == 0) s_unsat = 0;
        __syncthreads();
        const int w = __reduce_add_sync(0xffffffffu, mine);
        if ((threadIdx.x & 31) == 0 && w) atomicAdd(&s_unsat, w);
        __syncthreads();
        return s_unsat;
    };

    for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const float x = llr[k];
        post[k] = x;
        bits[k] = x < 0.0f;  // initial decision: lratio < 1
    }
    __syncthreads();

    // init: t = bf16(tanh(v0 / 2)) with v0 = bf16(llr) routed to the
    // check side; syndrome of the channel decisions from v0 < 0
    int mine = 0;
    for (int g = half; g < G; g += 2) {
        uint32_t mw[MW], pw[PW];
        begin_visit(g);
        load_pi(g, pw);
        int par = 0;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
            const float v0 = bf16_round(post[j * QT + pi_get(pw, j)]);
            row_set(mw, j, __float2bfloat16(tanhf(v0 * 0.5f)));
            par ^= (v0 < 0.0f);
        }
        store_row(mw);
        end_visit(g);
        mine += par;
    }
    int unsat = block_sum(mine);

    bool done = unsat == 0;  // uniform across the block
    int it = 0;
    for (int n = 0; n < max_iter && !(done && early_stop); ++n) {
        // phase B: check update + posterior accumulation. The halves work
        // on two cosets at once and scatter into the posterior in turn.
        for (int k = threadIdx.x; k < N; k += blockDim.x) post[k] = llr[k];
        __syncthreads();
        for (int g = half; g < G; g += 2) {
            uint32_t mw[MW], pw[PW];
            begin_visit(g);
            load_row(mw);
            // backward products bw[j] = t[j+1] * bw[j+1], kept at every
            // eighth j; each group of eight is multiplied out again below,
            // from its kept value, by the same operations
            float keep[NG];
            float acc = 1.0f;
#pragma unroll
            for (int j = JT - 1; j >= 0; --j) {
                if (j % 8 == 7) keep[j / 8] = acc;
                acc = row_get(mw, j) * acc;
            }
            float F = 1.0f;
#pragma unroll
            for (int k = 0; k < NG; ++k) {
                float bw[8];
                bw[7] = keep[k];
#pragma unroll
                for (int i = 6; i >= 0; --i) bw[i] = row_get(mw, 8 * k + i + 1) * bw[i + 1];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int j = 8 * k + i;
                    const float tj = row_get(mw, j);
                    float te = F * bw[i];  // exclusive product
                    te = fminf(fmaxf(te, -te_clip), te_clip);
                    row_set(mw, j, __float2bfloat16(logf((1.0f + te) / (1.0f - te))));  // the row now holds c2v
                    F = F * tj;
                }
            }
            store_row(mw);
            load_pi(g, pw);  // not needed before the scatter: its registers are free for the sweeps
            // post += c2v in coset order: wait for coset g - 1, pass on to g + 1
            if (g > 0) turn_wait(1 + (g & 1), 2 * QT);
#pragma unroll
            for (int k = 0; k < NG; ++k) {
                float pv[8];
                // entries of different j lie q apart: loads first, then stores
#pragma unroll
                for (int i = 0; i < 8; ++i) pv[i] = post[(8 * k + i) * QT + pi_get(pw, 8 * k + i)];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    post[(8 * k + i) * QT + pi_get(pw, 8 * k + i)] = pv[i] + row_get(mw, 8 * k + i);
            }
            if (g + 1 < G) turn_pass(1 + ((g + 1) & 1), 2 * QT);
            end_visit(g);
        }
        __syncthreads();
        // latch decisions: pr <= 1 with NaN -> 1 == !(post > 0)
        if (!done)
            for (int k = threadIdx.x; k < N; k += blockDim.x) bits[k] = !(post[k] > 0.0f);

        // phase C: variable update + syndrome of the new decisions
        mine = 0;
        for (int g = half; g < G; g += 2) {
            uint32_t mw[MW], pw[PW];
            begin_visit(g);
            load_row(mw);
            load_pi(g, pw);
            int par = 0;
#pragma unroll
            for (int j = 0; j < JT; ++j) {
                const float pp = bf16_round(post[j * QT + pi_get(pw, j)]);
                const float v = pp - row_get(mw, j);
                row_set(mw, j, __float2bfloat16(tanhf(v * 0.5f)));
                par ^= !(pp > 0.0f);
            }
            store_row(mw);
            end_visit(g);
            mine += par;
        }
        const int new_unsat = block_sum(mine);
        if (!done) {
            unsat = new_unsat;
            it = n + 1;
            done = new_unsat == 0;
        }
    }
    cp_async_wait_all();  // a prefetch may still be in flight
    if (threadIdx.x == 0) {
        unsat_out[b] = unsat;
        iters_out[b] = it;
    }
}

// ---------------------------------------------------------------------------
// The generic kernel: J and q at run time, q threads (rounded up to a warp).
// ---------------------------------------------------------------------------

// Two instantiations. <uint8_t, true>: message and pi tiles move through
// shared memory. <int32_t, false>: both are read in place.
template <typename PiT, bool STAGE>
__global__ void __launch_bounds__(1024, 1) bp_generic_kernel(
    const float* __restrict__ llr_c,        // [B, J*q] canonical order, sanitized
    const unsigned char* __restrict__ pi,   // [G, pi_stride bytes] of PiT, [J][q] per coset
    __nv_bfloat16* __restrict__ msg,        // [B, G, tile_stride] scratch, [J][q] per coset
    uint8_t* __restrict__ bits_c,           // [B, J*q] canonical order (out)
    int32_t* __restrict__ unsat_out,        // [B]
    int32_t* __restrict__ iters_out,        // [B]
    int G, int J, int q, int tile_stride, int pi_stride, int max_iter, int early_stop, float te_clip)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = J * q;
    // shared memory: [two tile buffers (STAGE)] [post f32 N] [bbuf f32 N]
    const int buf_bytes = tile_stride * 2 + pi_stride;
    float* post = reinterpret_cast<float*>(smem + (STAGE ? 2 * buf_bytes : 0));
    float* bbuf = post + N;  // [J][q] backward partial products
    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const bool active = r < q;
    const float* llr = llr_c + (size_t)b * N;
    __nv_bfloat16* m = msg + (size_t)b * G * tile_stride;
    uint8_t* bits = bits_c + (size_t)b * N;

    // ---- the ring of coset tiles -----------------------------------------
    int visit = 0;             // visits so far; visit v uses buffer v & 1
    bool prefetched = false;   // the current visit's tile is already on its way
    __nv_bfloat16* tile = nullptr;  // messages [J, q] of the current coset
    const PiT* ptile = nullptr;     // pi[g] of the current coset

    auto load_tile = [&](int g, int slot) {
        unsigned char* dst = smem + slot * buf_bytes;
        const unsigned char* src_m = reinterpret_cast<const unsigned char*>(m + (size_t)g * tile_stride);
        const unsigned char* src_p = pi + (size_t)g * pi_stride;
        const int nm = tile_stride * 2 / 16, np = pi_stride / 16;
        for (int k = threadIdx.x; k < nm; k += blockDim.x) cp_async16(dst + 16 * k, src_m + 16 * k);
        for (int k = threadIdx.x; k < np; k += blockDim.x)
            cp_async16(dst + tile_stride * 2 + 16 * k, src_p + 16 * k);
        cp_async_commit();
    };
    // Enter coset g: its tile is in shared memory when this returns, and
    // the next coset's tile is on its way into the other buffer (its last
    // store, at least one barrier back, is visible to this block).
    auto begin_visit = [&](int g) {
        if (STAGE) {
            const int slot = visit & 1;
            if (!prefetched) {
                __syncthreads();  // the tile's last store came from other threads
                load_tile(g, slot);
            }
            cp_async_wait_all();
            __syncthreads();
            prefetched = G > 1;
            if (prefetched) load_tile(g + 1 < G ? g + 1 : 0, slot ^ 1);
            tile = reinterpret_cast<__nv_bfloat16*>(smem + slot * buf_bytes);
            ptile = reinterpret_cast<const PiT*>(smem + slot * buf_bytes + tile_stride * 2);
        } else {
            tile = m + (size_t)g * tile_stride;
            ptile = reinterpret_cast<const PiT*>(pi + (size_t)g * pi_stride);
        }
    };
    // Leave coset g: every thread is done with the tile and the posterior;
    // the tile goes back to the slab.
    auto end_visit = [&](int g) {
        __syncthreads();
        if (STAGE) {
            const uint4* src = reinterpret_cast<const uint4*>(smem + (visit & 1) * buf_bytes);
            uint4* dst = reinterpret_cast<uint4*>(m + (size_t)g * tile_stride);
            for (int k = threadIdx.x; k < tile_stride * 2 / 16; k += blockDim.x) dst[k] = src[k];
        }
        ++visit;
    };

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
        begin_visit(g);
        int par = 0;
        if (active) {
#pragma unroll 8
            for (int j = 0; j < J; ++j) {
                const float v0 = bf16_round(post[j * q + (int)ptile[j * q + r]]);
                tile[j * q + r] = __float2bfloat16(tanhf(v0 * 0.5f));
                par ^= (v0 < 0.0f);
            }
        }
        unsat += __syncthreads_count(par);
        end_visit(g);
    }

    bool done = unsat == 0;  // uniform across the block
    int it = 0;
    for (int n = 0; n < max_iter && !(done && early_stop); ++n) {
        // phase B: check update + posterior accumulation, coset by coset
        for (int k = threadIdx.x; k < N; k += blockDim.x) post[k] = llr[k];
        __syncthreads();
        for (int g = 0; g < G; ++g) {
            begin_visit(g);
            if (active) {
                float acc = 1.0f;
                bbuf[(J - 1) * q + r] = acc;
                for (int j = J - 2; j >= 0; --j) {
                    acc = __bfloat162float(tile[(j + 1) * q + r]) * acc;
                    bbuf[j * q + r] = acc;
                }
                float F = 1.0f;
#pragma unroll 4
                for (int j = 0; j < J; ++j) {
                    const float tj = __bfloat162float(tile[j * q + r]);
                    float te = F * bbuf[j * q + r];  // exclusive product
                    te = fminf(fmaxf(te, -te_clip), te_clip);
                    const __nv_bfloat16 c = __float2bfloat16(logf((1.0f + te) / (1.0f - te)));
                    post[j * q + (int)ptile[j * q + r]] += __bfloat162float(c);
                    tile[j * q + r] = c;  // the tile now holds c2v
                    F = F * tj;
                }
            }
            end_visit(g);
        }
        // latch decisions: pr <= 1 with NaN -> 1 == !(post > 0)
        if (!done)
            for (int k = threadIdx.x; k < N; k += blockDim.x) bits[k] = !(post[k] > 0.0f);

        // phase C: variable update + syndrome of the new decisions
        int new_unsat = 0;
        for (int g = 0; g < G; ++g) {
            begin_visit(g);
            int par = 0;
            if (active) {
#pragma unroll 8
                for (int j = 0; j < J; ++j) {
                    const float pp = bf16_round(post[j * q + (int)ptile[j * q + r]]);
                    const float v = pp - __bfloat162float(tile[j * q + r]);
                    tile[j * q + r] = __float2bfloat16(tanhf(v * 0.5f));
                    par ^= !(pp > 0.0f);
                }
            }
            new_unsat += __syncthreads_count(par);
            end_visit(g);
        }
        if (!done) {
            unsat = new_unsat;
            it = n + 1;
            done = new_unsat == 0;
        }
    }
    if (STAGE) cp_async_wait_all();  // a prefetch may still be in flight
    if (threadIdx.x == 0) {
        unsat_out[b] = unsat;
        iters_out[b] = it;
    }
}

template <typename PiT, bool STAGE>
int launch_generic(const void* llr_c, const void* pi, void* msg, void* bits_c, void* unsat, void* iters,
                   int B, int G, int J, int q, int tile_stride, int pi_stride, int smem_bytes, int max_iter,
                   int early_stop, float te_clip, cudaStream_t stream)
{
    auto kernel = bp_generic_kernel<PiT, STAGE>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    const int threads = ((q + 31) / 32) * 32;
    kernel<<<B, threads, smem_bytes, stream>>>(
        (const float*)llr_c, (const unsigned char*)pi, (__nv_bfloat16*)msg, (uint8_t*)bits_c,
        (int32_t*)unsat, (int32_t*)iters, G, J, q, tile_stride, pi_stride, max_iter, early_stop, te_clip);
    return (int)cudaGetLastError();
}

}  // namespace

// unrolled, staged, tile_stride (bf16 elements), pi_stride (bytes) and
// smem_bytes come from the wrapper's kernel_layout; the unrolled kernel
// serves J = 72, q = 256. pi: the packed one-byte table for the unrolled
// and the staged kernel, the code's int32 table [G, J, q] for tiles in place.
extern "C" int bp_blocked_launch(
    const void* llr_c, const void* pi, void* msg, void* bits_c, void* unsat, void* iters,
    int B, int G, int J, int q, int unrolled, int staged, int tile_stride, int pi_stride,
    int smem_bytes, int max_iter, int early_stop, float te_clip, void* stream)
{
    if (B == 0) return 0;
    if (unrolled) {
        if (J != 72 || q != 256 || tile_stride != J * q || pi_stride != q * 80) return (int)cudaErrorInvalidValue;
        auto kernel = bp_unrolled_kernel<72, 256>;
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (e != cudaSuccess) return (int)e;
        kernel<<<B, 2 * 256, smem_bytes, (cudaStream_t)stream>>>(
            (const float*)llr_c, (const unsigned char*)pi, (__nv_bfloat16*)msg, (uint8_t*)bits_c,
            (int32_t*)unsat, (int32_t*)iters, G, max_iter, early_stop, te_clip);
        return (int)cudaGetLastError();
    }
    if (tile_stride % 8 || (staged ? q > 256 || pi_stride % 16 : pi_stride != 4 * J * q))
        return (int)cudaErrorInvalidValue;
#define BP_LAUNCH(PiT, STAGE)                                                                          \
    launch_generic<PiT, STAGE>(llr_c, pi, msg, bits_c, unsat, iters, B, G, J, q, tile_stride, pi_stride, \
                               smem_bytes, max_iter, early_stop, te_clip, (cudaStream_t)stream)
    return staged ? BP_LAUNCH(uint8_t, true) : BP_LAUNCH(int32_t, false);
#undef BP_LAUNCH
}
