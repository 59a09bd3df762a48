"""MEA max-DP + traceback of the device MSA's merges: the CUDA kernel
``mea_dp`` and its plain torch twin.

``mea_walk`` replaces the XLA scans ``_mea_forward`` + ``_walk`` of
``dna_ldpc_tpu/ops/msa/device_msa.py`` (:212, :257) — not a Pallas kernel
in the JAX package, but in eager torch each merge would be 2 Cmax
sequential steps of ~40 small launches. On CUDA tensors it launches
``csrc/mea_dp.cu`` (one thread block per cluster, one thread per DP lane,
the choice-code plane in shared memory, the walk by one thread); on CPU
tensors it runs ``mea_walk_ref``, the eager scan. A CUDA tensor launches
the kernel or raises.

The DP (MUSCLE's CalcAlnFlat + TraceBackFlat): cell (i, j) of the
(Cmax + 1) x (Cmax + 1) plane takes B = S(i-1, j-1) + post[i-1, j-1],
X = S(i-1, j), Y = S(i, j-1) with the tie order B >= X >= Y; row i = 0 is
'Y' and column j = 0 'X', both of value 0; cells off the plane (j < 0) are
NEG = -3e38 with code 0. The walk starts at (wA, wB) and emits, per
diagonal d = i + j, the code and lane of the cell it visits (0 where the
path skips the diagonal).
"""

from __future__ import annotations

import numpy as np
import torch

CB, CX, CY = 1, 2, 3          # path step codes ('B', 'X', 'Y'); 0 = none
NEG = float(np.float32(-3.0e38))

launches = 0  # kernel launches since the last reset (main-path evidence)


def mea_walk_ref(post, wA, wB, Cmax: int):
    """Plain torch twin of ``mea_dp``. post: [C, Cmax, Cmax] f32 (cell
    (i, j) reads post[i-1, j-1]); wA, wB: [C] operand widths. Returns
    (codes [C, 2 Cmax] uint8, pos [C, 2 Cmax] int32) indexed by diagonal
    d - 1, on the inputs' device."""
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


def _mea_walk_cuda(post, wA, wB, Cmax: int):
    global launches
    from ... import cuda_lib

    C, D = post.shape[0], 2 * Cmax
    if Cmax + 1 > 1024:
        raise ValueError(f"Cmax={Cmax} exceeds one block's threads")
    dev = post.device
    post = post.to(torch.float32).contiguous()
    wA = wA.to(torch.int32).contiguous()
    wB = wB.to(torch.int32).contiguous()
    codes = torch.empty((C, D), dtype=torch.uint8, device=dev)
    pos = torch.empty((C, D), dtype=torch.int32, device=dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        status = lib.mea_dp_launch(
            post.data_ptr(), wA.data_ptr(), wB.data_ptr(), codes.data_ptr(), pos.data_ptr(),
            C, Cmax, torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_lib.check(status, "mea_dp_launch")
    if C:
        launches += 1
    return codes, pos


def mea_walk(post, wA, wB, Cmax: int):
    """MEA path of each cluster's merge: the ``mea_dp`` kernel on CUDA
    tensors, the plain twin on CPU tensors (module docstring)."""
    C = post.shape[0]
    if post.shape != (C, Cmax, Cmax) or wA.shape != (C,) or wB.shape != (C,):
        raise ValueError("post must be [C, Cmax, Cmax] and wA, wB [C]")
    devs = {t.device for t in (post, wA, wB)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    dev = post.device
    if dev.type == "cpu":
        return mea_walk_ref(post, wA, wB, Cmax)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _mea_walk_cuda(post, wA, wB, Cmax)
