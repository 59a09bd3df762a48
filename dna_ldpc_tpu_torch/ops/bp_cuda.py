"""Fused blocked-code BP: the CUDA kernel K1 and its plain torch twin.

``bp_decode_blocked`` replaces the TPU kernel
``dna_ldpc_tpu/ops/bp_pallas.py::_bp_kernel`` (launched by
``_bp_pallas_call``; entry ``bp_decode_blocked_pallas``). On a CUDA
tensor it launches ``csrc/bp_blocked.cu`` (one thread block per codeword,
the messages staged coset by coset in shared memory, see the design notes
there); on a CPU tensor it runs
``bp_decode_blocked_ref``, the same arithmetic as plain torch ops. There
is no fallback between the two: a CUDA tensor launches the kernel or
raises.

Semantics of the TPU kernel, kept rounding point for rounding point:
NaN LLRs become -1e-30 and values are clipped to the finite range;
messages are bf16 tanh-domain values ``t = bf16(tanh(v / 2))`` with
``v0 = bf16(llr)``; the check update is an exact forward/backward
exclusive product of the bf16 ``t`` in f32, clipped to +-(1 - 1e-5), and
``c2v = bf16(log((1 + te) / (1 - te)))``; the posterior is
``llr + sum_g c2v`` summed in f32 in coset order; decisions are
``!(post > 0)``; parity comes from ``!(bf16(post) > 0)``; results latch at
the first zero syndrome, capped at ``max_iter``. ``early_stop=False`` is
the TPU kernel's fixed-work mode: every codeword runs all ``max_iter``
iterations and its results still latch at the first zero syndrome, so the
outputs equal the early-stopped ones word for word.

What bounds the kernel on the card: operations, not bytes. Per edge and
iteration it does one division, one ``logf`` and one ``tanhf`` with their
bf16 roundings, on J * q * G edges per codeword (147,456 for the deployed
code) with one codeword per SM; the bytes that must move (LLRs in, bits
out) are three orders below. The design keeps every sweep off global
memory: the bf16 message slab moves coset by coset through rings of two
shared-memory buffers (``cp.async`` in, 16-byte stores out).
``kernel_layout`` picks the kernel: the unrolled one for the deployed
J = 72, q = 256 (512 threads, each half of the block taking every other
coset; check-major tiles read into registers with 16-byte loads; the
posterior updated in coset order by turns; 221,184 bytes of shared
memory; pi as 80-byte rows packed by ``pack_pi``; the code renamed by
``bank_friendly_form`` so that a warp's posterior accesses fall in 32
different banks), the generic one with staged tiles for any other code
with q <= 256 whose tiles fit (8 J q + 2 message tiles and 2 pi tiles of
one byte per entry), and the generic one reading its tiles and the code's
int32 pi table in place (8 J q bytes) for the rest of the domain
``8 J q <= 232,448`` bytes, ``q <= 1024``. On the card staging ran
1.6-1.7x faster than in place at q = 64 and 256 and 10 % slower at
q = 512, where 16 warps hide the loads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.blocked import BlockedCode
from ..utils.gf import PRIMITIVE_POLYS, get_field
from ..utils.profiling import wait
from .bp import BpResult

# te is clipped so c2v survives bf16 tanh-domain storage (the TPU
# kernel's _TE_CLIP, as the float32 value its clip compares against)
TE_CLIP = float(np.float32(1.0 - 1e-5))
SMEM_LIMIT = 232448  # bytes of shared memory one block can use (sm_90)

launches = 0  # kernel launches since the last reset (main-path evidence)


UNROLLED_JQ = (72, 256)  # the (J, q) of the kernel with its sweeps unrolled (the deployed code's)


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """How the K1 kernel lays one code out (all sizes in bytes unless said)."""

    tile_stride: int   # bf16 elements between two cosets' message tiles (J * q rounded up to 8)
    pi_stride: int     # bytes between two cosets' pi tiles
    pi_row: int        # unrolled: bytes of one check's J entries (tiles are check-major [q][J]); else 0 ([J][q])
    unrolled: bool     # the kernel with J and q at compile time
    staged: bool       # tiles move through shared memory, pi packed to one byte per entry (else both in place)
    smem_bytes: int    # dynamic shared memory of one block


def kernel_layout(J: int, q: int) -> KernelLayout:
    """The kernel and buffer sizes for a code with J column groups of q
    variables; raises where no kernel can hold it."""
    n = J * q
    if q > 1024 or 8 * n > SMEM_LIMIT:
        raise ValueError(f"blocked code with J={J}, q={q} exceeds one block's threads or shared memory")
    tile_stride = -(-n // 8) * 8
    if (J, q) == UNROLLED_JQ:
        # check-major rows of whole 16-byte words; two halves x two tile buffers and the f32 posterior
        pi_row = -(-J // 16) * 16
        return KernelLayout(tile_stride, q * pi_row, pi_row, True, True, 4 * 2 * tile_stride + 4 * n)
    pi_stride = -(-n // 16) * 16
    ring = 2 * (2 * tile_stride + pi_stride)  # two buffers of a message tile and its one-byte pi tile
    if q <= 256 and ring + 8 * n <= SMEM_LIMIT:
        return KernelLayout(tile_stride, pi_stride, 0, False, True, ring + 8 * n)
    return KernelLayout(tile_stride, 4 * n, 0, False, False, 8 * n)  # the code's own int32 table


def pack_pi(pi: np.ndarray, layout: KernelLayout) -> np.ndarray:
    """pi [G, J, q], q <= 256, as the unrolled and the staged kernel read
    it: [G, pi_stride] bytes, one per entry. A coset's entries lie [J][q],
    zero-padded to a multiple of 16 bytes, or, for the unrolled kernel,
    [q][J] with each check's row zero-padded to ``pi_row`` bytes."""
    G, J, q = pi.shape
    if not layout.staged or q > 256:
        raise ValueError("only the kernels with staged tiles read a packed pi")
    out = np.zeros((G, layout.pi_stride), np.uint8)
    if layout.pi_row:
        out.reshape(G, q, layout.pi_row)[:, :, :J] = pi.transpose(0, 2, 1)
    else:
        out[:, : J * q] = pi.reshape(G, -1)
    return out


def bank_friendly_form(code: BlockedCode) -> BlockedCode | None:
    """The same code with its checks and variables renamed so that in every
    block the variable of check r is ``r XOR constant``, or None where the
    code has no such form.

    A warp of the unrolled kernel reads posterior entries pi[g, j, r] of 32
    consecutive checks r at a time; in the construction order those are 32
    scattered shared-memory banks (3.1 accesses deep on average for the
    deployed code), under ``r XOR constant`` they are 32 different ones.
    An RS-LDPC code (``models/rs_ldpc.py``) has the form: check r of coset g
    is the codeword beta_r * u + a_g over GF(q), so with checks named by
    beta_r and the variables of column group j by value / u_j, block (g, j)
    is the map beta -> beta XOR a_g[j] / u_j. Only names change: every
    variable keeps its edges, the cosets their order and the column groups
    theirs, so a decoder's arithmetic is the same operation for operation.
    ``col_to_canonical`` of the result takes external columns to the new
    names."""
    q, G, J = code.q, code.G, code.J
    s = q.bit_length() - 1
    if q != 1 << s or s not in PRIMITIVE_POLYS:
        return None
    field = get_field(s)
    val = np.concatenate([[0], field.exp_table[: q - 1]])      # name -> field element (loc's inverse)
    pi_val = val[code.pi]                                       # [G, J, q] field elements
    u = pi_val[0, :, 1]                                         # coset 0 is beta_r * u with beta_1 = 1
    if (u == 0).any():
        return None
    new_var = field.div(val[None, :], u[:, None])               # [J, q]: name v of group j -> new name
    pi_new = np.empty_like(code.pi)
    pi_new[:, :, val] = np.take_along_axis(                     # check r is renamed beta_r = val[r]
        np.broadcast_to(new_var[None], (G, J, q)), code.pi.astype(np.int64), axis=2
    ).astype(code.pi.dtype)
    if not ((pi_new ^ np.arange(q, dtype=pi_new.dtype)) == pi_new[:, :, :1]).all():
        return None
    canon = np.asarray(code.col_to_canonical, np.int64)
    group, name = canon // q, canon % q
    return dataclasses.replace(
        code, pi=pi_new, col_to_canonical=(group * q + new_var[group, name]).astype(np.int32)
    )


@dataclasses.dataclass(frozen=True)
class _CodeTensors:
    pi: torch.Tensor      # [G, J, q] int32: variable of check r in block (g, j)
    pinv: torch.Tensor    # [G, J, q] int64: check of variable v in block (g, j)
    canon: torch.Tensor   # [N] int64: llr_canonical = llr_external[:, canon]
    ext: torch.Tensor     # [N] int64: bits_external = bits_canonical[:, ext]


def _tables(code: BlockedCode, device: torch.device) -> _CodeTensors:
    cache = code.__dict__.setdefault("_torch_tables", {})
    if device not in cache:
        pi = np.asarray(code.pi, np.int32)
        cache[device] = _CodeTensors(
            pi=torch.as_tensor(pi, device=device),
            pinv=torch.as_tensor(np.argsort(pi, axis=-1), device=device),
            canon=torch.as_tensor(np.asarray(code.canonical_gather(), np.int64), device=device),
            ext=torch.as_tensor(np.asarray(code.external_gather(), np.int64), device=device),
        )
        wait(device, 4)  # the uploads
    return cache[device]


def _kernel_code(code: BlockedCode, layout: KernelLayout) -> BlockedCode:
    """The naming of the code the kernel runs on: bank-friendly where the
    unrolled kernel can use it, else the code's own."""
    if "_torch_kernel_code" not in code.__dict__:
        code.__dict__["_torch_kernel_code"] = (bank_friendly_form(code) if layout.unrolled else None) or code
    return code.__dict__["_torch_kernel_code"]


def _packed_pi(code: BlockedCode, layout: KernelLayout, device: torch.device) -> torch.Tensor:
    """The routing table as the layout's kernel reads it."""
    if not layout.staged:
        return _tables(code, device).pi
    cache = code.__dict__.setdefault("_torch_packed_pi", {})
    if device not in cache:
        cache[device] = torch.as_tensor(pack_pi(np.asarray(code.pi), layout), device=device)
        wait(device)
    return cache[device]


def _sanitize(llr: torch.Tensor) -> torch.Tensor:
    """NaN -> -1e-30 (the reference's NaN -> bit 1 rule), +-inf clipped."""
    llr = llr.to(torch.float32)
    big = float(torch.finfo(torch.float32).max)
    return torch.where(torch.isnan(llr), torch.full_like(llr, -1e-30), llr.clamp(-big, big))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bp_decode_blocked_ref(
    code: BlockedCode, llr: torch.Tensor, max_iter: int = 200, early_stop: bool = True
) -> BpResult:
    """Plain torch twin of the K1 kernel, on ``llr``'s device. llr: [B, N]
    in the code's external column order."""
    B = llr.shape[0]
    G, J, q = code.G, code.J, code.q
    tabs = _tables(code, llr.device)
    lc = _sanitize(llr)[:, tabs.canon].reshape(B, J, q)
    route_idx = tabs.pi.long().unsqueeze(0).expand(B, G, J, q)
    back_idx = tabs.pinv.unsqueeze(0).expand(B, G, J, q)

    def to_checks(x):  # [B, J, q(v)] -> [B, G, J, q(r)]
        return torch.gather(x.unsqueeze(1).expand(B, G, J, q), 3, route_idx)

    def to_vars(y):  # [B, G, J, q(r)] -> [B, G, J, q(v)]
        return torch.gather(y, 3, back_idx)

    def unsat_of(bits_pc):  # [B, G, J, q] bool decisions at the check side
        return (bits_pc.int().sum(2) % 2).sum((1, 2)).to(torch.int32)

    v0 = to_checks(_bf16(lc))
    t = torch.tanh(v0 * 0.5).to(torch.bfloat16)
    unsat = unsat_of(v0 < 0)
    bits = (lc < 0).to(torch.uint8)
    done = unsat == 0
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    n = 0
    while n < max_iter and not (early_stop and bool(done.all())):
        tf = t.float()
        # exclusive products over the J edges of each check, as the
        # kernel's two sweeps (same f32 multiplication order)
        acc = torch.ones_like(tf[:, :, 0])
        bwd = [acc] * J
        for j in range(J - 2, -1, -1):
            acc = tf[:, :, j + 1] * acc
            bwd[j] = acc
        F = torch.ones_like(acc)
        te = []
        for j in range(J):
            te.append(F * bwd[j])
            F = F * tf[:, :, j]
        te = torch.stack(te, 2).clamp(-TE_CLIP, TE_CLIP)
        c2v = _bf16(torch.log((1.0 + te) / (1.0 - te)))
        cv = to_vars(c2v)
        post = lc
        for g in range(G):  # coset order, as the kernel accumulates
            post = post + cv[:, g]
        bits = torch.where(done[:, None, None], bits, (~(post > 0)).to(torch.uint8))
        postpc = to_checks(_bf16(post))
        t = torch.tanh((postpc - c2v) * 0.5).to(torch.bfloat16)
        new_unsat = unsat_of(~(postpc > 0))
        unsat = torch.where(done, unsat, new_unsat)
        iters = torch.where(done, iters, torch.full_like(iters, n + 1))
        done = done | (new_unsat == 0)
        n += 1
    bits = bits.reshape(B, J * q)[:, tabs.ext]
    return BpResult(bits=bits, success=unsat == 0, iterations=iters, unsat=unsat)


def _bp_decode_blocked_cuda(code: BlockedCode, llr: torch.Tensor, max_iter: int, early_stop: bool) -> BpResult:
    global launches
    from .. import cuda_lib

    G, J, q = code.G, code.J, code.q
    lay = kernel_layout(J, q)
    B = llr.shape[0]
    code = _kernel_code(code, lay)
    tabs = _tables(code, llr.device)
    pi = _packed_pi(code, lay, llr.device)
    llr_c = _sanitize(llr)[:, tabs.canon].contiguous()
    msg = torch.empty((B, G, lay.tile_stride), dtype=torch.bfloat16, device=llr.device)
    bits_c = torch.empty((B, J * q), dtype=torch.uint8, device=llr.device)
    unsat = torch.empty(B, dtype=torch.int32, device=llr.device)
    iters = torch.empty(B, dtype=torch.int32, device=llr.device)
    lib = cuda_lib.load()
    with torch.cuda.device(llr.device):
        status = lib.bp_blocked_launch(
            llr_c.data_ptr(), pi.data_ptr(), msg.data_ptr(), bits_c.data_ptr(),
            unsat.data_ptr(), iters.data_ptr(), B, G, J, q, int(lay.unrolled), int(lay.staged),
            lay.tile_stride, lay.pi_stride, lay.smem_bytes, int(max_iter), int(early_stop), TE_CLIP,
            torch.cuda.current_stream(llr.device).cuda_stream,
        )
    cuda_lib.check(status, "bp_blocked_launch")
    if B:
        launches += 1
    bits = bits_c[:, tabs.ext]
    return BpResult(bits=bits, success=unsat == 0, iterations=iters, unsat=unsat)


def bp_decode_blocked(
    code: BlockedCode, llr: torch.Tensor, max_iter: int = 200, early_stop: bool = True
) -> BpResult:
    """Decode LLRs [B, N] (external column order) of a blocked code:
    the K1 kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if llr.dim() != 2 or llr.shape[1] != code.n_vars:
        raise ValueError(f"llr must be [B, {code.n_vars}], got {tuple(llr.shape)}")
    if llr.device.type == "cpu":
        return bp_decode_blocked_ref(code, llr, max_iter, early_stop)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return _bp_decode_blocked_cuda(code, llr, max_iter, early_stop)
