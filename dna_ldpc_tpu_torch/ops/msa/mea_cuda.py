"""The merge of the device MSA — BuildPost, the MEA max-DP and its
traceback — as one hand-written CUDA kernel, and its plain torch twin.

``merge_walk`` (kernel ``merge_dp``, ``csrc/mea_dp.cu``) takes the batch's
assembled pair posteriors and the two projected operands and returns the
MEA path of each cluster's merge. It replaces the XLA program
``_build_post`` -> ``_mea_forward`` -> ``_walk`` of
``dna_ldpc_tpu/ops/msa/device_msa.py`` (:175, :212, :257; one-hot matmuls
and two scans in the JAX package, not a Pallas kernel). The kernel reads
its operand straight from the pair tensor ``P [C, npair, L+1, L+1]``
(pairs s1 < s2 in cluster_pairs(nb) slots): the pair (s1, s2) as stored
where s1 < s2, transposed where s1 > s2. So neither the JAX package's
per-cluster block matrix ``Pblock [C, nb (L+1), nb (L+1)]`` (the pairs
and their transposes laid out by member, zero diagonal blocks), nor the
profile-profile posterior ``post [C, Cmax, Cmax]``, nor BuildPost's first
sum ``T [C, Cmax, nb (L + 1)]`` exists in device memory.

On CUDA tensors it launches the kernel or raises; on CPU tensors it runs
the twin (``merge_walk_ref`` = ``_build_post`` + ``mea_walk_ref``, the
eager gathers and scans).

BuildPost, per cell (x, y) of the operands' (wA x wB) box, with
``Pblock[c, s1 (L+1) + l1, s2 (L+1) + l2]`` standing for
``P[c, slot(s1, s2), l1, l2]`` (s1 < s2), ``P[c, slot(s2, s1), l2, l1]``
(s1 > s2) and 0 (s1 = s2)::

    post[x, y] = sum over s2 in B, ascending, in f32, of
                   f32(bf16(sum over s1 in A, ascending, in f32, of
                            Pblock[c, s1 (L+1) + cposA[c, s1, x],
                                      s2 (L+1) + cposB[c, s2, y]]))

(a gap sentinel ``cpos = L`` reads the zero gap row or column of the
pair; the twin adds the zero gap row for every sequence outside A or B,
which changes no sum of non-negative values, so the kernel loops over the
members only).

The DP (MUSCLE's CalcAlnFlat + TraceBackFlat): cell (i, j) of the
(Cmax + 1) x (Cmax + 1) plane takes B = S(i-1, j-1) + post[i-1, j-1],
X = S(i-1, j), Y = S(i, j-1) with the tie order B >= X >= Y; row i = 0 is
'Y' and column j = 0 'X', both of value 0; cells off the plane (j < 0) are
NEG = -3e38 with code 0. The walk starts at (wA, wB) and emits, per
diagonal d = i + j, the code and lane of the cell it visits (0 where the
path skips the diagonal). Only the box [0..wA] x [0..wB] can reach the
output — the walk moves to smaller i and j only, and a cell of the box
depends on cells of the box only — so the kernel sweeps the box alone; the
twin sweeps the whole plane.
"""

from __future__ import annotations

import numpy as np
import torch

CB, CX, CY = 1, 2, 3          # path step codes ('B', 'X', 'Y'); 0 = none
NEG = float(np.float32(-3.0e38))

merge_launches = 0  # merge_dp launches since the last reset (main-path evidence)

# the kernel's lanes hold strips of up to MAX_STRIP columns of the box
MAX_STRIP = 9
MAX_CMAX = 32 * MAX_STRIP - 1
MAX_MEMBERS = 64  # sequences a cluster: a warp's two ballots


def _row_block(P, s: int, nb: int):
    """Row block s of the JAX package's ``Pblock`` from the pair tensor:
    [C, L+1, nb (L+1)], the pair (s, s2) as stored for s2 > s, (s2, s)
    transposed for s2 < s, zero for s2 = s."""
    C, _, L1, _ = P.shape
    blocks = []
    for s2 in range(nb):
        if s2 == s:
            blocks.append(P.new_zeros((C, L1, L1)))
        elif s < s2:
            blocks.append(P[:, s * nb - s * (s + 1) // 2 + s2 - s - 1])
        else:
            blocks.append(P[:, s2 * nb - s2 * (s2 + 1) // 2 + s - s2 - 1].transpose(1, 2))
    return torch.cat(blocks, 2)


def _build_post(P, cposA, cposB, mA, mB, Cmax: int, L: int):
    """Profile-profile posterior (BuildPost): [C, Cmax, Cmax] f32.

    T[c, x, (s2, l2)] = sum over s1 in A of Pblock[c, s1*(L+1) +
    cposA[c, s1, x], (s2, l2)] in f32, rounded to bf16; then post[c, x, y]
    = sum over s2 in B of T[c, x, s2*(L+1) + cposB[c, s2, y]] in f32
    (``Pblock`` as the module docstring reads it from the pair tensor
    ``P``). Gap sentinels and rows outside A (columns outside B) read a
    zero gap row (column)."""
    C, nb, _ = cposA.shape
    L1 = L + 1
    K = nb * L1
    base = torch.arange(nb, device=cposA.device)[None, :, None] * L1
    rows = torch.where(mA[:, :, None], cposA[:, :, :Cmax].long(), L)
    cols = torch.where(mB[:, :, None], cposB[:, :, :Cmax].long() + base, L)
    T = torch.zeros((C, Cmax, K), dtype=torch.float32, device=P.device)
    for s in range(nb):
        T += _row_block(P, s, nb).gather(1, rows[:, s, :, None].expand(C, Cmax, K))
    Tb = T.to(torch.bfloat16)
    del T
    post = torch.zeros((C, Cmax, Cmax), dtype=torch.float32, device=P.device)
    for s in range(nb):
        post += Tb.gather(2, cols[:, s, None, :].expand(C, Cmax, Cmax))
    return post


def mea_walk_ref(post, wA, wB, Cmax: int):
    """The MEA max-DP and walk of ``merge_dp``'s twin, from the posterior
    plane. post: [C, Cmax, Cmax] f32 (cell (i, j) reads post[i-1, j-1]);
    wA, wB: [C] operand widths. Returns (codes [C, 2 Cmax] uint8,
    pos [C, 2 Cmax] int32) indexed by diagonal d - 1, on the inputs'
    device."""
    dev = post.device
    C, W, D = post.shape[0], Cmax + 1, 2 * Cmax
    f32 = torch.float32
    lane = torch.arange(W, device=dev)[None, :]
    negcol = torch.full((C, 1), NEG, dtype=f32, device=dev)

    # Xp[:, d-1, i] = post[c, i-1, d-i-1] (the operand of cell (i, d-i)),
    # 0 at lane 0 and off the plane
    d = torch.arange(1, D + 1, device=dev)[:, None]
    col = d - lane - 1
    ok = (lane >= 1) & (col >= 0) & (col < Cmax)
    flat = (lane - 1).clamp(min=0) * Cmax + col.clamp(0, Cmax - 1)
    Xp = torch.where(ok, post.reshape(C, -1)[:, flat], 0.0)

    def shr(a):  # value at lane - 1 (NEG past the edge)
        return torch.cat([negcol, a[:, :-1]], 1)

    plane = torch.empty((D, C, W), dtype=torch.uint8, device=dev)
    prev2 = torch.full((C, W), NEG, dtype=f32, device=dev)
    prev1 = torch.where(lane == 0, 0.0, NEG).to(f32).expand(C, W)
    for dd in range(1, D + 1):
        j = dd - lane
        pB = shr(prev2) + Xp[:, dd - 1]
        pX = shr(prev1)
        pY = prev1
        bx, by, xy = pB >= pX, pB >= pY, pX >= pY
        inner = torch.where(bx, torch.where(by, pB, pY), torch.where(xy, pX, pY))
        icode = torch.where(bx, torch.where(by, CB, CY), torch.where(xy, CX, CY))
        b0 = lane == 0
        bj = (j == 0) & (lane > 0)
        val = torch.where(b0 | bj, 0.0, inner)
        code = torch.where(b0, CY, torch.where(bj, CX, icode))
        invalid = j < 0
        plane[dd - 1] = torch.where(invalid, 0, code).to(torch.uint8)
        prev2, prev1 = prev1, torch.where(invalid, NEG, val).to(f32)

    codes = torch.zeros((C, D), dtype=torch.uint8, device=dev)
    pos = torch.zeros((C, D), dtype=torch.int32, device=dev)
    i_cur = wA.to(torch.int64)
    d_cur = (wA + wB).to(torch.int64)
    for dd in range(D, 0, -1):
        active = d_cur == dd
        inside = (i_cur >= 0) & (i_cur < W)
        code = plane[dd - 1].gather(1, i_cur.clamp(0, W - 1)[:, None])[:, 0].to(torch.int64)
        code = torch.where(active & inside, code, 0)
        codes[:, dd - 1] = code.to(torch.uint8)
        pos[:, dd - 1] = torch.where(active, i_cur, 0).to(torch.int32)
        step_ix = active & ((code == CB) | (code == CX))
        i_cur = torch.where(step_ix, i_cur - 1, i_cur)
        d_cur = torch.where(active, torch.where(code == CB, d_cur - 2, d_cur - 1), d_cur)
    return codes, pos


def merge_walk_ref(P, cposA, cposB, mA, mB, wA, wB, Cmax: int, L: int):
    """Plain torch twin of ``merge_dp``: BuildPost into device memory, then
    the full-plane DP and walk."""
    return mea_walk_ref(_build_post(P, cposA, cposB, mA, mB, Cmax, L), wA, wB, Cmax)


def _one_device(*tensors) -> torch.device:
    """The tensors' common device: "cpu" (the twin runs) or "cuda" (the
    kernel runs); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def merge_walk(P, cposA, cposB, mA, mB, wA, wB, Cmax: int, L: int):
    """MEA path of each cluster's merge of the profiles A and B, straight
    from the pair posteriors: the ``merge_dp`` kernel on CUDA tensors, the
    plain twin on CPU tensors (module docstring).

    P: [C, npair, L+1, L+1] bf16, the batch's assembled pairs in
    cluster_pairs(nb) slots with a zero gap row and column at L
    (``device_msa.assemble_transform``); cposA, cposB: [C, nb, Cmax+1]
    int32 projected column maps (gap = L); mA, mB: [C, nb] bool
    membership; wA, wB: [C] int32 operand widths. Returns (codes
    [C, 2 Cmax] uint8, pos [C, 2 Cmax] int32) indexed by diagonal d - 1."""
    global merge_launches
    C, nb = mA.shape
    npair = nb * (nb - 1) // 2
    if (P.shape != (C, npair, L + 1, L + 1) or P.dtype != torch.bfloat16 or cposA.shape != (C, nb, Cmax + 1)
            or cposB.shape != cposA.shape or mB.shape != (C, nb) or wA.shape != (C,) or wB.shape != (C,)):
        raise ValueError("P must be [C, npair, L+1, L+1] bf16, cposA/cposB [C, nb, Cmax+1], mA/mB [C, nb], "
                         "wA/wB [C]")
    if mA.dtype != torch.bool or mB.dtype != torch.bool:
        raise ValueError("mA and mB must be bool")
    dev = _one_device(P, cposA, cposB, mA, mB, wA, wB)
    if dev.type == "cpu":
        return merge_walk_ref(P, cposA, cposB, mA, mB, wA, wB, Cmax, L)
    if nb > MAX_MEMBERS or L + 1 > 65535:
        raise ValueError(f"nb={nb}, L={L}: the kernel takes at most {MAX_MEMBERS} sequences and L + 1 <= 65535")
    if Cmax > MAX_CMAX:
        raise ValueError(f"Cmax={Cmax} exceeds the kernel's {MAX_STRIP} columns per lane (Cmax <= {MAX_CMAX})")
    from ... import cuda_lib

    args = (P.contiguous(), cposA.to(torch.int32).contiguous(), cposB.to(torch.int32).contiguous(),
            mA.contiguous(), mB.contiguous(), wA.to(torch.int32).contiguous(), wB.to(torch.int32).contiguous())
    codes = torch.empty((C, 2 * Cmax), dtype=torch.uint8, device=dev)
    pos = torch.empty((C, 2 * Cmax), dtype=torch.int32, device=dev)
    if C:
        with torch.cuda.device(dev):
            status = cuda_lib.load().merge_dp_launch(
                *(a.data_ptr() for a in args), codes.data_ptr(), pos.data_ptr(), C, nb, L, Cmax,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        cuda_lib.check(status, "merge_dp_launch")
        merge_launches += 1
    return codes, pos
