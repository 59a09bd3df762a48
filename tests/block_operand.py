"""The merge's operand as it was before the merge kernel read the pair
tensor: the per-cluster block matrix of the pairs (the JAX package's
``build_pblock``) and BuildPost from it. The merge tests hold the
pair-tensor operand bit-equal to it. Imports neither ``jax`` nor the JAX
package, so the card's tests use it too."""

import numpy as np
import torch


def pblock(P, nb: int):
    """``Pblock[c, s1 (L+1) + l, s2 (L+1) + m]`` of the bf16 pair tensor
    ``P`` [C, npair, L+1, L+1]: pair (s1, s2) at (l, m) for s1 < s2, pair
    (s2, s1) at (m, l) for s1 > s2, zero for s1 = s2."""
    C, _, L1, _ = P.shape
    out = torch.zeros((C, nb, L1, nb, L1), dtype=torch.bfloat16, device=P.device)
    for s, (a, b) in enumerate(zip(*np.triu_indices(nb, 1))):
        out[:, a, :, b, :] = P[:, s]
        out[:, b, :, a, :] = P[:, s].transpose(1, 2)
    return out.view(C, nb * L1, nb * L1)


def pblock_build_post(Pblock, cposA, cposB, mA, mB, Cmax: int, L: int):
    """BuildPost from the block matrix: T[c, x, k] = sum over s1 in A of
    Pblock[c, s1 (L+1) + cposA[c, s1, x], k] in f32 (every other sequence
    reads the zero gap row of block 0), rounded to bf16; post = sum over s2
    in B of T at s2 (L+1) + cposB[c, s2, y] in f32."""
    C, nb, _ = cposA.shape
    L1, dev = L + 1, Pblock.device
    K = nb * L1
    base = torch.arange(nb, device=dev)[None, :, None] * L1
    rows = torch.where(mA[:, :, None], cposA[:, :, :Cmax].long() + base, L)
    cols = torch.where(mB[:, :, None], cposB[:, :, :Cmax].long() + base, L)
    T = torch.zeros((C, Cmax, K), dtype=torch.float32, device=dev)
    for s in range(nb):
        T += Pblock.gather(1, rows[:, s, :, None].expand(C, Cmax, K))
    Tb = T.to(torch.bfloat16)
    post = torch.zeros((C, Cmax, Cmax), dtype=torch.float32, device=dev)
    for s in range(nb):
        post += Tb.gather(2, cols[:, s, None, :].expand(C, Cmax, Cmax))
    return post
