"""Device-resident batched progressive alignment + iterative refinement.

Port of ``dna_ldpc_tpu/ops/msa/device_msa.py``, function by function, in
plain torch on the posteriors' device. The progressive joins and the
refinement re-alignments of every cluster of a batch run as batched
merges on the device; only the final column maps leave it.

Reference semantics (MUSCLE v5, vendored in the reference):

- ``MPCFlat::ProgressiveAlign`` / ``ProgAln`` (progalnflat.cpp:41-100):
  merge profiles pairwise along the UPGMA join order;
- ``BuildPost`` (buildpostflat.cpp:18-100): profile-profile posterior
  P[c1, c2] = sum over (s1 in A, s2 in B) of the pair posterior at the
  letter positions mapped to columns c1/c2;
- ``CalcAlnFlat`` + ``TraceBackFlat``: MEA max-DP with tie preference
  B >= X >= Y, boundary rows/cols fixed to X/Y — with BuildPost one CUDA
  kernel on the card, ``merge_dp`` (``mea_cuda.merge_walk``);
- ``AlignAlns`` (alnalnsflat.cpp:7-44): gap insertion along the path;
- ``MPCFlat::Refine`` / ``RefineIter`` (refineflat.cpp:4-31): seeded
  random bipartitions, re-align the two projected sub-MSAs; a cluster
  freezes after 5 consecutive no-change iterations.

Representation: per cluster c and sequence s, ``cpos[c, s, u]`` holds the
letter position of s at column u of s's current profile, or the sentinel
L for a gap. Projection compacts the columns where a selected row has a
letter (cumsum + scatter + gather); BuildPost gathers the rows and columns
of a per-cluster block matrix of the pair posteriors (``build_pblock``) —
inside the merge kernel on the card, as eager gathers in its twin — where
the JAX package multiplies by one-hot matrices on the TPU's matrix unit:
the same values, the first sum rounded to bf16 as the JAX package rounds
its first product, the second kept in f32. Gap insertion remaps cpos
through the path's column maps.

Exactness: the MEA recurrence, tie preference, boundary codes, projection
and convergence rule match the host path (``align()`` + native/ingest.cpp)
operation for operation; BuildPost differs from it in bf16 rounding and
summation order exactly as the JAX package's device path does
(``dna_ldpc_tpu/ops/msa/device_msa.py:52-62``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import pairhmm
from .align import CONVERGE_AFTER, _refine_masks
from .consistency import consistency_core
from .mea_cuda import CB, CX, CY, merge_walk

# cluster-size buckets of the device MSA (n pads up to the next bucket;
# zero pair blocks and all-false masks make pad slots inert)
MSA_BUCKETS = (2, 4, 8, 12, 16, 32)
# column budget Cmax = Lpad + COLUMN_SLACK: reads of one strand differ by a
# few indels, so the aligned width barely exceeds the longest read (width
# overflow falls back to the host aligner)
COLUMN_SLACK = 32


def cluster_bytes(nb: int, Lpad: int) -> int:
    """Device bytes one cluster of bucket nb holds during a batch: the
    assembled bf16 pairs and the bf16 Pblock. The merge kernel builds its
    operand on chip; its twin on the CPU still makes BuildPost's f32 first
    sum, about a fifth more at bucket 8."""
    L1 = Lpad + 1
    return nb * (nb - 1) // 2 * L1 * L1 * 2 + (nb * L1) ** 2 * 2


def wave_masks(joins: list[tuple[int, int]], n_true: int, nb: int):
    """Per-wave operand membership masks for one cluster's join order
    (node ids: leaves 0..n-1, internal n+k). Returns (maskA, maskB):
    [nb-1, nb] bool, padded with all-false waves."""
    leaf: dict[int, np.ndarray] = {}
    for i in range(n_true):
        m = np.zeros(nb, bool)
        m[i] = True
        leaf[i] = m
    mA = np.zeros((nb - 1, nb), bool)
    mB = np.zeros((nb - 1, nb), bool)
    for k, (a, b) in enumerate(joins):
        mA[k] = leaf[a]
        mB[k] = leaf[b]
        leaf[n_true + k] = leaf.pop(a) | leaf.pop(b)
    return mA, mB


# ---------------------------------------------------------------------------
# The batched merge step (BuildPost + MEA DP + traceback + gap insertion)
# ---------------------------------------------------------------------------


def _project(cpos, mask, Cmax: int, L: int):
    """Compact the columns where any mask-selected row has a letter
    (MultiSequence::Project). cpos: [C, nb, Cmax+1]; returns
    (cposS [C, nb, Cmax+1], w [C] int32)."""
    C, nb, CP1 = cpos.shape
    occ = ((cpos < L) & mask[:, :, None]).any(1)  # [C, CP1]
    occ[:, Cmax] = False
    w = occ.sum(1, dtype=torch.int32)
    tgt = torch.where(occ, occ.cumsum(1) - 1, Cmax)  # dummy slot for dropped columns
    inv = torch.full((C, CP1), Cmax, dtype=torch.int64, device=cpos.device)
    inv.scatter_(1, tgt, torch.arange(CP1, device=cpos.device).expand(C, CP1))
    inv[:, Cmax] = Cmax  # sentinel slot (duplicate dummy writes land here): the gap column
    cposS = cpos.gather(2, inv[:, None, :].expand(C, nb, CP1))
    cposS[:, :, Cmax] = L
    return cposS, w


def build_pblock(P, nb: int):
    """Arrange a batch's pair posteriors [C, npair, L+1, L+1] (zero gap
    row/col at L) as the symmetric per-sequence block matrix
    ``Pblock[c, s1*(L+1)+l, s2*(L+1)+m]`` in bf16 (zero diagonal blocks,
    lower triangle transposed)."""
    C, npair, L1, _ = P.shape
    Pb = P.to(torch.bfloat16)
    out = torch.zeros((C, nb, L1, nb, L1), dtype=torch.bfloat16, device=P.device)
    ii, jj = np.triu_indices(nb, k=1)
    for s, (a, b) in enumerate(zip(ii.tolist(), jj.tolist())):
        out[:, a, :, b, :] = Pb[:, s]
        out[:, b, :, a, :] = Pb[:, s].transpose(1, 2)
    return out.view(C, nb * L1, nb * L1)


def _merge_step(Pblock, cpos, width, mA, mB, upd_ok, Cmax: int, L: int):
    """One batched merge (progressive wave or refine re-alignment).
    Returns (cpos', width', changed [C] bool, overflow_now [C] bool)."""
    C, nb, CP1 = cpos.shape
    dvec = torch.arange(1, 2 * Cmax + 1, device=cpos.device)[None, :]

    cposA, wA = _project(cpos, mA, Cmax, L)
    cposB, wB = _project(cpos, mB, Cmax, L)
    codes, pos = merge_walk(Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, L)
    pos = pos.long()

    valid = codes != 0
    T = valid.sum(1, dtype=torch.int32)
    overflow_now = T > Cmax
    t = valid.cumsum(1) - 1
    isBX = (codes == CB) | (codes == CX)
    isBY = (codes == CB) | (codes == CY)
    tgtA = torch.where(valid & isBX & (t < Cmax), t, Cmax)
    tgtB = torch.where(valid & isBY & (t < Cmax), t, Cmax)
    amap = torch.full((C, CP1), Cmax, dtype=torch.int64, device=cpos.device)
    bmap = torch.full((C, CP1), Cmax, dtype=torch.int64, device=cpos.device)
    amap.scatter_(1, tgtA, pos - 1)
    bmap.scatter_(1, tgtB, (dvec - pos) - 1)
    amap[:, Cmax] = Cmax  # duplicate dummy writes land here
    bmap[:, Cmax] = Cmax
    amap = amap.clamp(0, Cmax)
    bmap = bmap.clamp(0, Cmax)

    newA = cposA.gather(2, amap[:, None, :].expand(C, nb, CP1))
    newB = cposB.gather(2, bmap[:, None, :].expand(C, nb, CP1))
    newcpos = torch.where(mA[..., None], newA, torch.where(mB[..., None], newB, cpos))
    newcpos[:, :, Cmax] = L
    newwidth = torch.where(mA | mB, T[:, None], width)

    changed = (newcpos != cpos).any(2).any(1) | (newwidth != width).any(1)

    upd = upd_ok & mA.any(1) & ~overflow_now
    cpos = torch.where(upd[:, None, None], newcpos, cpos)
    width = torch.where(upd[:, None], newwidth, width)
    return cpos, width, changed, overflow_now


# ---------------------------------------------------------------------------
# Batch programs
# ---------------------------------------------------------------------------


def _msa_init(lens, Cmax: int, L: int):
    """cpos0 [C, nb, Cmax+1] int32, width0 [C, nb] from sequence lengths
    (leaf profiles)."""
    u = torch.arange(Cmax + 1, dtype=torch.int32, device=lens.device)[None, None, :]
    cpos = torch.where(u < lens[:, :, None], u, L).to(torch.int32)
    return cpos, lens.to(torch.int32)


def _msa_progressive(Pblock, cpos, width, jA, jB, Cmax: int, L: int):
    """Run the progressive waves (jA/jB: [nwaves, C, nb] bool numpy; a
    wave no cluster joins in is inert and skipped). Returns
    (cpos, width, overflow [C])."""
    dev = cpos.device
    ovf = torch.zeros(cpos.shape[0], dtype=torch.bool, device=dev)
    for k in range(jA.shape[0]):
        if not jA[k].any():
            continue
        mA = torch.as_tensor(jA[k], device=dev)
        mB = torch.as_tensor(jB[k], device=dev)
        cpos, width, _, ovf_now = _merge_step(Pblock, cpos, width, mA, mB, ~ovf, Cmax, L)
        ovf = ovf | (ovf_now & mA.any(1))
    return cpos, width, ovf


def _msa_refine(Pblock, cpos, width, frozen, ovf, rA, rows_pc, Cmax: int, L: int):
    """Run the refinement loop to convergence (rA: [iters, C, nb]
    bipartition masks, side B = the complement over the true sequences;
    rows_pc: [C] per-cluster mask-table length). A cluster freezes after
    5 consecutive no-change iterations; the host loop tests once per
    iteration whether any cluster is still live (one sync each) and exits
    when every cluster is frozen, overflowed, or out of mask rows."""
    unchanged = torch.zeros(cpos.shape[0], dtype=torch.int32, device=cpos.device)
    it = 0
    while it < rA.shape[0] and bool((~(frozen | ovf) & (rows_pc > it)).any()):
        mA = rA[it]
        mB = (cpos < L).any(2) & ~mA
        row_valid = mA.any(1)
        upd_ok = ~frozen & ~ovf
        cpos, width, changed, ovf_now = _merge_step(Pblock, cpos, width, mA, mB, upd_ok, Cmax, L)
        ovf = ovf | (ovf_now & upd_ok & row_valid)
        act = row_valid & upd_ok
        unchanged = torch.where(act, torch.where(changed, 0, unchanged + 1), unchanged)
        frozen = frozen | (unchanged >= CONVERGE_AFTER)
        it += 1
    return cpos, width, frozen, ovf


def assemble_transform(posts, ids, mask, inv_n, nb: int, iters: int, C_cap: int, L: int):
    """Gather a batch's pair posteriors from the device-resident pair
    tensor ``posts`` [P, L, L] (``ids`` [C_cap * npair] flat pair
    indices, ``mask`` covering pad slots), bf16-round them, and apply the
    consistency transform for buckets of >= 3 sequences (``inv_n`` [C_cap]
    = 1/n_true over the bucket-padded zero blocks), in cluster chunks
    sized from the byte budget. Returns [C_cap, npair, L+1, L+1] bf16 with
    a zero gap row/col."""
    npair = nb * (nb - 1) // 2
    out = torch.zeros((C_cap, npair, L + 1, L + 1), dtype=torch.bfloat16, device=posts.device)
    transform = bool(iters) and nb >= 3
    # consistency_core holds ~5 f32 block tensors [nb, nb, L, L] per cluster
    ck = max(1, pairhmm.BUDGET_BYTES // (5 * nb * nb * L * L * 4)) if transform else C_cap
    for lo in range(0, C_cap, ck):
        hi = min(C_cap, lo + ck)
        sel = posts[ids[lo * npair : hi * npair]]
        sel = torch.where(mask[lo * npair : hi * npair, None, None], sel, 0)
        pm = sel.to(torch.bfloat16).to(torch.float32).view(hi - lo, npair, L, L)
        if transform:
            pm = consistency_core(pm, inv_n[lo:hi], nb, iters)
        out[lo:hi, :, :L, :L] = pm
    return out


# ---------------------------------------------------------------------------
# Batch entry points
# ---------------------------------------------------------------------------


class MsaJob:
    """A started device MSA batch; :meth:`collect` downloads its column
    maps and builds the aligned rows."""

    def __init__(self, seqs_list, cpos, width, ovf, L: int):
        self._seqs = seqs_list
        self._cpos, self._width, self._ovf = cpos, width, ovf
        self._L = L

    def collect(self):
        """(rows_per_cluster, overflow_flags): rows_per_cluster[c] is the
        aligned [(ordinal, row)] list (None where overflow), matching
        align()'s output contract."""
        L = self._L
        C_true = len(self._seqs)
        cpos_np = self._cpos[:C_true].cpu().numpy()
        width_np = self._width[:C_true].amax(1).cpu().numpy()
        ovf_np = self._ovf[:C_true].cpu().numpy()
        out: list = []
        for c, seqs in enumerate(self._seqs):
            if ovf_np[c]:
                out.append(None)
                continue
            w = int(width_np[c])
            rows = []
            for s, q in enumerate(seqs):
                qb = np.frombuffer(q.encode("latin1"), np.uint8)
                qb = np.concatenate([qb, np.full(L + 1 - len(qb), ord("-"), np.uint8)])
                row = qb[np.minimum(cpos_np[c, s, :w], L)]
                rows.append((s, row.tobytes().decode("latin1")))
            out.append(rows)
        return out, ovf_np


def start_msa_batch(
    P,
    seqs_list: list[list[str]],
    joins_list: list[list[tuple[int, int]]],
    nb: int,
    Lpad: int,
    refine_iters: int,
    seed: int,
) -> MsaJob:
    """Run one bucket batch's device MSA (progressive + refinement) on
    P's device.

    P: [C_cap, npair, Lpad+1, Lpad+1] (f32 or bf16), zero-padded at
    row/col Lpad and on pad pairs/clusters. seqs_list/joins_list: the
    C_true real clusters (C_true <= C_cap)."""
    dev = P.device
    C_cap = P.shape[0]
    C_true = len(seqs_list)
    Cmax = Lpad + COLUMN_SLACK
    L = Lpad

    lens = np.zeros((C_cap, nb), np.int32)
    for c, seqs in enumerate(seqs_list):
        lens[c, : len(seqs)] = [len(q) for q in seqs]
    jA = np.zeros((nb - 1, C_cap, nb), bool)
    jB = np.zeros((nb - 1, C_cap, nb), bool)
    for c, (seqs, joins) in enumerate(zip(seqs_list, joins_list)):
        jA[:, c, :], jB[:, c, :] = wave_masks(joins, len(seqs), nb)

    Pblock = build_pblock(P, nb)
    cpos, width = _msa_init(torch.as_tensor(lens, device=dev), Cmax, L)
    cpos, width, ovf = _msa_progressive(Pblock, cpos, width, jA, jB, Cmax, L)

    # refinement: per-cluster mask tables by true n (clusters with n < 3
    # skip refinement entirely -> all-false rows)
    tables = {n: _refine_masks(n, refine_iters, seed) for n in {len(s) for s in seqs_list}}
    max_rows = max((t.shape[0] for t in tables.values()), default=0)
    if max_rows:
        rA = np.zeros((max_rows, C_cap, nb), bool)
        rows_pc = np.zeros(C_cap, np.int32)
        for c, seqs in enumerate(seqs_list):
            tab = tables[len(seqs)]
            k, n = tab.shape
            rA[:k, c, :n] = tab.astype(bool)
            rows_pc[c] = k
        frozen = torch.as_tensor(np.arange(C_cap) >= C_true, device=dev)
        cpos, width, frozen, ovf = _msa_refine(
            Pblock, cpos, width, frozen, ovf, torch.as_tensor(rA, device=dev),
            torch.as_tensor(rows_pc, device=dev), Cmax, L,
        )
    return MsaJob(seqs_list, cpos, width, ovf, L)


def run_msa_batch(
    P,
    seqs_list: list[list[str]],
    joins_list: list[list[tuple[int, int]]],
    nb: int,
    Lpad: int,
    refine_iters: int,
    seed: int,
):
    """start_msa_batch + collect."""
    return start_msa_batch(P, seqs_list, joins_list, nb, Lpad, refine_iters, seed).collect()
