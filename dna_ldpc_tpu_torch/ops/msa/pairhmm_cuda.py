"""Pair-HMM posteriors + EA scores: the CUDA kernel K2 and its plain
torch twin.

``post_ea`` replaces the TPU kernel
``dna_ldpc_tpu/ops/msa/pairhmm_pallas.py::_kernel`` (launched by
``_post_pallas``; entry ``batch_post_ea_pallas``). On CUDA tensors it
launches ``csrc/pairhmm.cu`` (one warp per pair, a wavefront in
registers); on CPU tensors it runs ``post_ea_ref``, the same recurrences
as plain torch ops vectorized over pairs. A CUDA tensor launches the
kernel or raises. The reads are rows of read tables and a pair names its
two rows through index tensors (identity when none are given), so
``pairhmm.k2_posteriors`` packs and uploads each read of a trial once
however many pairs it takes part in.

Both compute the TPU kernel's three phases:

1. forward sweep of the 5-state pair-HMM in log space, keeping the
   forward M values and capturing total = lse_s(Fwd[s](lx, ly) + start[s]);
2. anti-causal backward sweep in natural coordinates (terminal
   Bwd[s](lx, ly) = start[s]) fused with the posterior
   exp(min(F_M + B_M - total, 0)), zeroed below 0.01 and outside the
   pair's [1..lx] x [1..ly] box, written in the compact [P, Lmax, Lmax]
   layout;
3. the MEA max-DP over the bf16-rounded posterior, whose corner value is
   the pair's EA score — bit-equal to the native ``mea_score`` on the same
   bf16-rounded posterior, which UPGMA tie-breaks rely on.

The twin sweeps antidiagonals of the whole (Lmax + 1)^2 plane; the kernel
sweeps only the pair's box, lane by lane, and runs phase 3 backward inside
phase 2 (every bf16 posterior is a multiple of 2^-14 in [2^-7, 1], so the
sums are exact in f32 and the direction does not change the score). A
cell's value depends only on its three neighbours, so the sweep order
changes no bit.

What bounds the kernel on the card: operations — 13 expf + 5 logf per
cell forward, 14 + 5 backward, ~23k cells per pair of 150-nt reads; the
f32 posteriors out (102 KB per pair at Lmax = 160) are the bytes that
must move, a tenth of that time. The design spends no barrier and no
shared memory on the DP: lane l of the pair's warp owns
R = ceil((lx + 1) / 32) <= 6 consecutive rows in registers and takes the
row above from lane l - 1 by shuffle, one column behind it; reads above
191 nt are swept in bands of 192 rows. The forward M values go to a
global scratch laid out [band][step][row of strip][lane], so that every
store and load is a coalesced 128-byte line and a lane reads back only
what it wrote; ``kernel_layout`` sizes it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.profiling import device_time
from .pairhmm import CONST_NAMES, MIN_SPARSE_PROB, hmm_consts

launches = 0  # kernel launches since the last reset (main-path evidence)
pairs = 0     # read pairs those launches processed

NEG = float(np.float32(-1e30))
_MIN_PROB = float(np.float32(MIN_SPARSE_PROB))


def _lse(*ts):
    """log-sum-exp in the kernel's order: running max, then the sum of
    exp(t - m) term by term, then m + log(s)."""
    m = ts[0]
    for t in ts[1:]:
        m = torch.maximum(m, t)
    s = torch.zeros_like(m)
    for t in ts:
        s = s + torch.exp(t - m)
    return m + torch.log(s)


def post_ea_ref(xc, yc, lx, ly, Lmax: int):
    """Plain torch twin of K2. xc, yc: [P, Lmax] integer codes (4 =
    wildcard/padding); lx, ly: [P] lengths. Returns (post [P, Lmax, Lmax]
    f32, ea [P] f32) on the inputs' device."""
    dev = xc.device
    P, W, D = xc.shape[0], Lmax + 1, 2 * Lmax
    c = dict(zip(CONST_NAMES, (float(v) for v in hmm_consts())))
    f32 = torch.float32
    lane = torch.arange(W, device=dev)[None, :]
    lx = lx.to(torch.int64)[:, None]
    ly = ly.to(torch.int64)[:, None]
    lsum = lx + ly
    wild = torch.full((P, 1), 4, dtype=torch.int64, device=dev)
    # xs[:, k] = x char at 1-based position k (wildcard at 0 and Lmax+1)
    xs = torch.cat([wild, xc.to(torch.int64), wild], 1)
    ys = torch.cat([wild, yc.to(torch.int64), wild], 1)
    neg = torch.full((P, W), NEG, dtype=f32, device=dev)
    negcol = neg[:, :1]

    def ychar(j):  # y char at 1-based position j (wildcard outside 1..Lmax)
        return ys.gather(1, j.clamp(0, Lmax + 1).expand(P, W))

    def m_emit(a, b):
        w = (a == 4) | (b == 4)
        same = torch.where(a == b, c["eDIAG"], c["eOTH"])
        return torch.where(w, c["eW16"], same).to(f32)

    def i_emit(a):
        return torch.where(a == 4, c["eW4"], c["eMARG"]).to(f32)

    def shr(a):  # value at row i-1
        return torch.cat([negcol, a[:, :-1]], 1)

    def shl(a):  # value at row i+1
        return torch.cat([a[:, 1:], negcol], 1)

    def nz(mask, v):
        return torch.where(mask, v, neg)

    # ---- phase 1: forward sweep ----------------------------------------
    xi = xs[:, :W]
    x_emit = i_emit(xi)
    fm = torch.empty((D + 1, P, W), dtype=f32, device=dev)
    fm[0] = neg
    start = torch.where(lane == 0, 0.0, NEG).to(f32).expand(P, W)
    prev2 = (neg,) * 6
    prev1 = (neg,) * 5 + (start,)
    corner = [neg[:, 0]] * 5
    for d in range(1, D + 1):
        j = d - lane
        yj = ychar(j)
        p2s = [shr(a) for a in prev2]
        cM = _lse(
            p2s[0] + c["tMM"], p2s[1] + c["tISM"], p2s[2] + c["tISM"],
            p2s[3] + c["tILM"], p2s[4] + c["tILM"], p2s[5] + c["sM"],
        ) + m_emit(xi, yj)
        s_m, s_ix, s_jx, s_s = shr(prev1[0]), shr(prev1[1]), shr(prev1[3]), shr(prev1[5])
        cIX = _lse(s_m + c["tMIS"], s_ix + c["tISIS"], s_s + c["sIS"]) + x_emit
        cJX = _lse(s_m + c["tMIL"], s_jx + c["tILIL"], s_s + c["sIL"]) + x_emit
        y_emit = i_emit(yj)
        cIY = _lse(prev1[0] + c["tMIS"], prev1[2] + c["tISIS"], prev1[5] + c["sIS"]) + y_emit
        cJY = _lse(prev1[0] + c["tMIL"], prev1[4] + c["tILIL"], prev1[5] + c["sIL"]) + y_emit
        valid = (j >= 0) & (j <= Lmax)
        cur = (
            nz(valid & (lane >= 1) & (j >= 1), cM),
            nz(valid & (lane >= 1), cIX),
            nz(valid & (j >= 1), cIY),
            nz(valid & (lane >= 1), cJX),
            nz(valid & (j >= 1), cJY),
            neg,
        )
        fm[d] = cur[0]
        hit = (lsum[:, 0] == d)
        for s in range(5):
            corner[s] = torch.where(hit, cur[s].gather(1, lx)[:, 0], corner[s])
        prev2, prev1 = prev1, cur
    total = _lse(
        corner[0] + c["sM"], corner[1] + c["sIS"], corner[2] + c["sIS"],
        corner[3] + c["sIL"], corner[4] + c["sIL"],
    )[:, None]

    # ---- phase 2: backward sweep + fused posterior ----------------------
    xn = xs[:, 1 : W + 1]  # x char at row i+1
    em_x = i_emit(xn)
    plane = torch.empty((D + 1, P, W), dtype=f32, device=dev)
    prev2 = prev1 = (neg,) * 5
    for d in range(D, -1, -1):
        j = d - lane
        yn = ychar(j + 1)
        em_m, em_y = m_emit(xn, yn), i_emit(yn)
        a_m = em_m + shl(prev2[0])
        a_ix = em_x + shl(prev1[1])
        a_jx = em_x + shl(prev1[3])
        a_iy = em_y + prev1[2]
        a_jy = em_y + prev1[4]
        b = [
            _lse(a_m + c["tMM"], a_ix + c["tMIS"], a_iy + c["tMIS"],
                 a_jx + c["tMIL"], a_jy + c["tMIL"]),
            _lse(a_m + c["tISM"], a_ix + c["tISIS"]),
            _lse(a_m + c["tISM"], a_iy + c["tISIS"]),
            _lse(a_m + c["tILM"], a_jx + c["tILIL"]),
            _lse(a_m + c["tILM"], a_jy + c["tILIL"]),
        ]
        term = (lane == lx) & (lsum == d)
        for s, key in enumerate(("sM", "sIS", "sIS", "sIL", "sIL")):
            b[s] = torch.where(term, c[key], b[s]).to(f32)
        post = torch.exp(torch.clamp(fm[d] + b[0] - total, max=0.0))
        ok = (lane >= 1) & (lane <= lx) & (j >= 1) & (j <= ly) & (post >= _MIN_PROB)
        plane[d] = torch.where(ok, post, 0.0)
        prev2, prev1 = prev1, tuple(b)
    ii = torch.arange(1, Lmax + 1, device=dev)
    post = plane[ii[:, None] + ii[None, :], :, ii[:, None]].permute(2, 0, 1).contiguous()

    # ---- phase 3: MEA max-DP over the bf16-rounded posterior ------------
    pb = plane.to(torch.bfloat16).to(f32)
    prev2 = neg
    prev1 = torch.where(lane == 0, 0.0, NEG).to(f32).expand(P, W)
    best = neg[:, 0]
    for d in range(1, D + 1):
        j = d - lane
        cur = torch.maximum(torch.maximum(shr(prev2) + pb[d], shr(prev1)), prev1)
        valid = (j >= 0) & (j <= Lmax)
        cur = torch.where(valid & ((lane == 0) | (j == 0)), 0.0, cur)
        cur = torch.where(valid, cur, NEG).to(f32)
        best = torch.where(lsum[:, 0] == d, cur.gather(1, lx)[:, 0], best)
        prev2, prev1 = prev1, cur
    ea = torch.where(lsum[:, 0] >= 1, torch.clamp(best, min=0.0), 0.0).to(f32)
    return post, ea


STRIP_ROWS = 6  # most rows one lane keeps in registers (the kernel's RMAX)


def kernel_layout(Lmax: int) -> dict:
    """Scratch sizes per pair of the K2 kernel at Lmax: ``fm_stride`` f32 of
    forward-M scratch (bands of 32 * STRIP_ROWS rows x (Lmax + 32) steps x
    STRIP_ROWS x 32 lanes) and ``edge_floats`` f32 of band-edge rows (0
    when one band holds every read)."""
    if Lmax + 1 > 1024:
        raise ValueError(f"Lmax={Lmax} exceeds the kernel's domain (Lmax <= 1023)")
    bands = -(-(Lmax + 1) // (32 * STRIP_ROWS))
    return {
        "fm_stride": bands * (Lmax + 32) * STRIP_ROWS * 32,
        "edge_floats": 2 * 5 * (Lmax + 1) if bands > 1 else 0,
    }


@functools.lru_cache(maxsize=None)
def _consts_on(dev: torch.device) -> torch.Tensor:
    """hmm_consts() on the card ``dev``, uploaded once, through page-locked
    memory: no wait."""
    return torch.from_numpy(hmm_consts()).pin_memory().to(dev, non_blocking=True)


def _post_ea_cuda(xc, yc, lx, ly, a, b, post, ea, Lmax: int):
    global launches, pairs
    from ... import cuda_lib

    P = post.shape[0]
    lay = kernel_layout(Lmax)
    dev = xc.device
    xc = xc.to(torch.int8).contiguous()
    yc = yc.to(torch.int8).contiguous()
    lx = lx.to(torch.int32).contiguous()
    ly = ly.to(torch.int32).contiguous()
    if a is not None:
        a = a.to(torch.int32).contiguous()
        b = b.to(torch.int32).contiguous()
    fwdm = torch.empty((P, lay["fm_stride"]), dtype=torch.float32, device=dev)
    edge = torch.empty((P, lay["edge_floats"]), dtype=torch.float32, device=dev)
    lib = cuda_lib.load()
    with torch.cuda.device(dev), device_time(dev):
        status = lib.pairhmm_launch(
            xc.data_ptr(), yc.data_ptr(), lx.data_ptr(), ly.data_ptr(),
            None if a is None else a.data_ptr(), None if b is None else b.data_ptr(),
            _consts_on(dev).data_ptr(), fwdm.data_ptr(), edge.data_ptr(), post.data_ptr(), ea.data_ptr(),
            P, Lmax, lay["fm_stride"], torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_lib.check(status, "pairhmm_launch")
    if P:
        launches += 1
        pairs += P
    return post, ea


def post_ea(xc, yc, lx, ly, Lmax: int, a=None, b=None, post=None, ea=None):
    """Posteriors [P, Lmax, Lmax] and EA scores [P] for encoded pairs:
    the K2 kernel on CUDA tensors, the plain twin on CPU tensors.

    xc [Rx, Lmax], yc [Ry, Lmax]: integer codes (4 = wildcard/padding) of
    the reads, lx [Rx], ly [Ry] their lengths. Pair p is row ``a[p]`` of
    xc and row ``b[p]`` of yc (index tensors [P]; both or neither); without
    them, row p of each (Rx = Ry = P). ``post`` (f32 [P, Lmax, Lmax]) and
    ``ea`` (f32 [P]), contiguous, take the results when given; the twin
    runs on the gathered rows and copies into them."""
    if (a is None) != (b is None):
        raise ValueError("give both index tensors a, b or neither")
    P = xc.shape[0] if a is None else a.shape[0]
    if a is None and (yc.shape[0] != P or lx.shape != (P,) or ly.shape != (P,)):
        raise ValueError("xc, yc must be [P, Lmax] and lx, ly [P]")
    if a is not None and (a.shape != (P,) or b.shape != (P,)):
        raise ValueError("a, b must be [P]")
    if xc.shape[1:] != (Lmax,) or yc.shape[1:] != (Lmax,) or lx.shape != xc.shape[:1] or ly.shape != yc.shape[:1]:
        raise ValueError("xc, yc must be [R, Lmax] and lx, ly their lengths")
    given = [t for t in (a, b, post, ea) if t is not None]
    devs = {t.device for t in (xc, yc, lx, ly, *given)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    for t, shape in ((post, (P, Lmax, Lmax)), (ea, (P,))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"an output must be float32, contiguous and {shape}")
    dev = xc.device
    if dev.type == "cpu":
        if a is not None:
            a, b = a.long(), b.long()
            xc, yc, lx, ly = xc[a], yc[b], lx[a], ly[b]
        p, e = post_ea_ref(xc, yc, lx, ly, Lmax)
        return (p if post is None else post.copy_(p)), (e if ea is None else ea.copy_(e))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if post is None:
        post = torch.empty((P, Lmax, Lmax), dtype=torch.float32, device=dev)
    if ea is None:
        ea = torch.empty(P, dtype=torch.float32, device=dev)
    return _post_ea_cuda(xc, yc, lx, ly, a, b, post, ea, Lmax)
