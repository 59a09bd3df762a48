"""The device MSA's merge (BuildPost + MEA DP + walk) of the port,
``mea_cuda.merge_walk``, on the CPU — where it runs its plain twin — and
plain-Python models of what its CUDA kernel computes.

- ``merge_walk`` against the JAX package's ``_build_post`` ->
  ``_mea_forward`` -> ``_walk`` on the same seeded numpy inputs. The two
  BuildPosts sum the same bf16 values in f32 in another order, so the
  planes agree to 1e-6 relative (the tolerance of
  tests/test_torch_device_msa.py) and are bit-equal where every sum is
  exact (single reads a side, or dyadic posteriors); codes and positions
  must be equal exactly wherever the planes are bit-equal, and may differ
  only in a cluster whose planes differ (a near-tie).
- The kernel's per-cell BuildPost — loops over the members of A and B
  only, in ascending order — equals ``_build_post`` bit for bit, though
  the latter also adds the zero gap row of block 0 for every non-member.
- The kernel's sweep — only the box [0..wA] x [0..wB], a lane per strip
  of columns, two-bit codes packed per lane and step, the walk on the
  packed plane — gives the codes and positions of the full-plane
  ``mea_walk_ref``, by hypothesis over the widths, with planted ties.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from dna_ldpc_tpu.ops.msa import device_msa as j_dm
from dna_ldpc_tpu_torch.ops.msa import device_msa as t_dm
from dna_ldpc_tpu_torch.ops.msa import mea_cuda
from dna_ldpc_tpu_torch.ops.msa.mea_cuda import CB, CX, CY

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)


def merge_inputs(seed: int, nb: int, multi: bool, kind: str, C: int = 5, L: int = 18, Cmax: int = 24):
    """A batched merge as ``_merge_step`` sees it: the block matrix of
    random pair posteriors ("random": uniform, 30 % dense; "dyadic":
    multiples of 1/64 whose sums are exact in bf16; 0.5 more on the
    diagonal), two projected operands and their masks and widths. ``multi``: pairs of sequences
    are merged first, so both sides hold several gapped rows; else single
    reads a side. The last cluster is a pad cluster (no reads, all-false
    masks)."""
    rng = np.random.default_rng(seed)
    npair = nb * (nb - 1) // 2
    P = np.zeros((C, npair, L + 1, L + 1), np.float32)
    dense = rng.random((C, npair, L, L)) < 0.3
    if kind == "dyadic":
        P[:, :, :L, :L] = rng.integers(0, 5, (C, npair, L, L)) / 64.0 * dense
    else:
        P[:, :, :L, :L] = rng.random((C, npair, L, L)) * dense
    idx = np.arange(L)
    P[:, :, idx, idx] += 0.5  # reads of one strand: most of the mass on the diagonal
    lens = rng.integers(L // 2, L + 1, (C, nb)).astype(np.int32)
    lens[-1] = 0
    P[-1] = 0
    Pblock = t_dm.build_pblock(torch.from_numpy(P), nb)
    cpos, width = t_dm._msa_init(torch.from_numpy(lens), Cmax, L)
    mA = np.zeros((C, nb), bool)
    mB = np.zeros((C, nb), bool)
    if multi:
        # first wave: (0, 1), (2, 3), ... joined, so the operands below have gaps
        ok = torch.ones(C, dtype=torch.bool)
        for a in range(0, nb - 1, 2):
            wa, wb = np.zeros((C, nb), bool), np.zeros((C, nb), bool)
            wa[:-1, a], wb[:-1, a + 1] = True, True
            cpos, width, _, _ = t_dm._merge_step(Pblock, cpos, width, torch.from_numpy(wa), torch.from_numpy(wb),
                                                 ok, Cmax, L)
        half = nb // 2 - nb // 2 % 2
        mA[:-1, :half] = True
        mB[:-1, half:] = True
        mB[0, nb - 1] = False  # one cluster with a sequence in neither operand
    else:
        a = rng.integers(0, nb, C - 1)
        mA[np.arange(C - 1), a] = True
        mB[np.arange(C - 1), (a + 1 + rng.integers(0, nb - 1, C - 1)) % nb] = True
    tA, tB = torch.from_numpy(mA), torch.from_numpy(mB)
    cposA, wA = t_dm._project(cpos, tA, Cmax, L)
    cposB, wB = t_dm._project(cpos, tB, Cmax, L)
    return Pblock, cposA, cposB, tA, tB, wA, wB, Cmax, L


@pytest.mark.parametrize("kind", ["random", "dyadic"])
@pytest.mark.parametrize("nb,multi", [(2, False), (4, False), (4, True), (8, False), (8, True)])
def test_merge_walk_matches_jax(nb, multi, kind):
    Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, L = merge_inputs(10 * nb + multi, nb, multi, kind)
    if multi:
        assert ((cposA[:, :, : Cmax // 2] == L) & mA[:, :, None]).any()  # gaps inside an operand
    before = mea_cuda.merge_launches, mea_cuda.launches
    codes, pos = mea_cuda.merge_walk(Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, L)
    assert (mea_cuda.merge_launches, mea_cuda.launches) == before  # CPU tensors: the twin ran
    assert codes.dtype == torch.uint8 and pos.dtype == torch.int32 and codes.shape == pos.shape == (len(wA), 2 * Cmax)

    j_post = j_dm._build_post(
        jnp.asarray(Pblock.float().numpy()).astype(jnp.bfloat16), jnp.asarray(cposA.numpy()),
        jnp.asarray(cposB.numpy()), jnp.asarray(mA.numpy()), jnp.asarray(mB.numpy()), Cmax, L,
    )
    cd = j_dm._mea_forward(j_post, Cmax)
    want_codes, want_pos = (np.asarray(a) for a in j_dm._walk(cd, jnp.asarray(wA.numpy()), jnp.asarray(wB.numpy()), Cmax))
    j_post = np.asarray(j_post)
    t_post = mea_cuda._build_post(Pblock, cposA, cposB, mA, mB, Cmax, L).numpy()
    np.testing.assert_allclose(t_post, j_post, rtol=1e-6, atol=0)  # f32 sums in another order
    same_plane = (t_post == j_post).all((1, 2))
    if kind == "dyadic" or not multi:
        assert same_plane.all()  # every sum exact: nothing to round differently
    same_path = (codes.numpy() == want_codes).all(1) & (pos.numpy() == want_pos).all(1)
    assert same_path[same_plane].all()
    assert same_path.sum() >= len(same_path) - 1  # a near-tie may flip in a cluster whose planes differ
    # the pad cluster: empty operands, an empty path
    assert int(wA[-1]) == int(wB[-1]) == 0 and not codes[-1].any() and not pos[-1].any()
    assert (want_codes[:-1] != 0).any(1).all()


def test_member_only_sums_equal_build_post():
    """BuildPost per cell, over the members of A and B only (what the
    kernel computes), against ``_build_post`` (which adds a zero for every
    other sequence): equal bit for bit, on the whole [Cmax, Cmax] plane."""
    Pblock, cposA, cposB, mA, mB, _, _, Cmax, L = merge_inputs(7, 4, True, "random", C=3, L=10, Cmax=14)
    want = mea_cuda._build_post(Pblock, cposA, cposB, mA, mB, Cmax, L)
    got = torch.zeros_like(want)
    zero = torch.zeros((), dtype=torch.float32)
    for c in range(Pblock.shape[0]):
        A = [s for s in range(4) if mA[c, s]]
        B = [s for s in range(4) if mB[c, s]]
        for x in range(Cmax):
            rows = [s * (L + 1) + int(cposA[c, s, x]) for s in A]
            for y in range(Cmax):
                post = zero.clone()
                for s2 in B:
                    col = s2 * (L + 1) + int(cposB[c, s2, y])
                    first = zero.clone()
                    for row in rows:
                        first = first + Pblock[c, row, col].float()
                    post = post + first.to(torch.bfloat16).float()
                got[c, x, y] = post
    assert (want > 0).float().mean() > 0.1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# A model of the kernel's sweep: the box only, packed codes
# ---------------------------------------------------------------------------


def pack_codes(codes) -> int:
    """A lane's strip of two-bit codes as one word, code r at bits 2r."""
    word = 0
    for r, code in enumerate(codes):
        word |= int(code) << (2 * r)
    return word


def unpack_code(word: int, r: int) -> int:
    return (word >> (2 * r)) & 3


def box_walk(post: np.ndarray, wa: int, wb: int, Cmax: int):
    """One cluster as ``csrc/mea_dp.cu`` computes it: lane l owns the
    columns l R .. l R + R - 1 (R = wb // 32 + 1) of the box
    [0..wa] x [0..wb] and computes row t - l at step t; its codes of a step
    are one packed word at plane[t][l]; the walk reads cell (i, j) from
    plane[i + j // R][j // R]."""
    R = wb // 32 + 1
    nl = wb // R + 1
    plane = np.zeros((wa + nl, 32), np.int64)
    S = np.zeros((wa + 1, nl * R), np.float32)
    for i in range(wa + 1):
        for lane in range(nl):
            codes = []
            for r in range(R):
                j = lane * R + r
                if i == 0:
                    codes.append(CY)
                    continue
                if j == 0:
                    codes.append(CX)
                    continue
                op = post[i - 1, j - 1] if j <= wb else np.float32(0)
                pB, pX, pY = S[i - 1, j - 1] + op, S[i - 1, j], S[i, j - 1]
                S[i, j] = max(pB, pX, pY)
                codes.append((CB if pB >= pY else CY) if pB >= pX else (CX if pX >= pY else CY))
            plane[i + lane, lane] = pack_codes(codes)
    out_codes = np.zeros(2 * Cmax, np.uint8)
    out_pos = np.zeros(2 * Cmax, np.int32)
    ic, jc = wa, wb
    while ic + jc > 0:
        code = unpack_code(int(plane[ic + jc // R, jc // R]), jc % R)
        out_codes[ic + jc - 1], out_pos[ic + jc - 1] = code, ic
        ic, jc = ic - (code in (CB, CX)), jc - (code in (CB, CY))
    return out_codes, out_pos


@settings(deadline=None)
@given(st.lists(st.integers(0, 3), min_size=1, max_size=16))
def test_pack_round_trip(codes):
    word = pack_codes(codes)
    assert word < 4 ** len(codes)
    assert [unpack_code(word, r) for r in range(len(codes))] == codes


CMAX_BOX = 70  # three strip widths: wb < 32, < 64, >= 64


@settings(max_examples=30, deadline=None)
@given(st.integers(0, CMAX_BOX), st.integers(0, CMAX_BOX), st.integers(0, 2**31 - 1), st.booleans())
def test_box_sweep_matches_full_plane(wa, wb, seed, ties):
    rng = np.random.default_rng(seed)
    post = rng.random((CMAX_BOX, CMAX_BOX)).astype(np.float32)
    if ties:  # a few values: exact ties between B, X and Y
        post = (rng.integers(0, 3, (CMAX_BOX, CMAX_BOX)) * 0.5).astype(np.float32)
    want_codes, want_pos = mea_cuda.mea_walk_ref(
        torch.from_numpy(post)[None], torch.tensor([wa], dtype=torch.int32), torch.tensor([wb], dtype=torch.int32),
        CMAX_BOX,
    )
    codes, pos = box_walk(post, wa, wb, CMAX_BOX)
    np.testing.assert_array_equal(codes, want_codes[0].numpy())
    np.testing.assert_array_equal(pos, want_pos[0].numpy())


@pytest.mark.parametrize("wa,wb", [(0, 0), (0, CMAX_BOX), (CMAX_BOX, 0), (CMAX_BOX, CMAX_BOX), (1, 31), (31, 32), (5, 64)])
def test_box_sweep_edges(wa, wb):
    test_box_sweep_matches_full_plane.hypothesis.inner_test(wa, wb, wa * 100 + wb, True)


def test_merge_walk_checks_its_inputs():
    Pblock, cposA, cposB, mA, mB, wA, wB, Cmax, L = merge_inputs(1, 2, False, "random")
    with pytest.raises(ValueError, match="Pblock must be"):
        mea_cuda.merge_walk(Pblock.float(), cposA, cposB, mA, mB, wA, wB, Cmax, L)
    with pytest.raises(ValueError, match="Pblock must be"):
        mea_cuda.merge_walk(Pblock, cposA[:, :, :-1], cposB, mA, mB, wA, wB, Cmax, L)
    with pytest.raises(ValueError, match="must be bool"):
        mea_cuda.merge_walk(Pblock, cposA, cposB, mA.int(), mB, wA, wB, Cmax, L)
    with pytest.raises(ValueError, match="several devices"):
        mea_cuda.merge_walk(Pblock, cposA, cposB, mA, mB, wA.to("meta"), wB, Cmax, L)


def test_merge_bound_counts_the_selected_blocks_and_the_box():
    from dna_ldpc_tpu_torch.utils import roofline

    widths_and_paths = 8 + 2 * 192 * 5
    # one read a side: the wA x wB box of one block (bf16), wA + wB map entries (int32), two mask bytes
    first, by = roofline.merge_bound_ms([1] * 512, [1] * 512, [136] * 512, [135] * 512, 192)
    want = 512 * (2 * 136 * 135 + 4 * (136 + 135) + 2 + widths_and_paths)
    assert by == "bytes" and first == pytest.approx(1e3 * want / 3.35e12, rel=1e-12)
    # several reads a side: every selected block's box, every member's map
    later, _ = roofline.merge_bound_ms([6], [2], [150], [140], 192)
    assert later == pytest.approx(
        1e3 * (2 * 12 * 150 * 140 + 4 * (6 * 150 + 2 * 140) + 8 + widths_and_paths) / 3.35e12, rel=1e-12)
    # a pad cluster selects no block and no map; its widths and (empty) path still move
    pad, _ = roofline.merge_bound_ms([0], [0], [0], [0], 192)
    assert pad == pytest.approx(1e3 * widths_and_paths / 3.35e12, rel=1e-12)
    # operations: |A| |B| adds, |B| roundings and the DP's 4 per cell of the (wA + 1) x (wB + 1) box
    ops = roofline.bound_ms(0, 151 * 141 * (16 * 16 + 16 + 4))[0]
    wide, by = roofline.merge_bound_ms([16], [16], [150], [140], 286)
    assert by == "bytes" and wide > ops > 0
    assert wide < roofline.merge_bound_ms([16], [16], [250], [240], 286)[0]
