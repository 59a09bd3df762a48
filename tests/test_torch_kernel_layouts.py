"""Host-side layouts of the two redesigned CUDA kernels, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py);
what surrounds them is plain Python that these tests reach: K1's choice of
instantiation, shared-memory budget and packed routing table
(``bp_cuda.kernel_layout``, ``pack_pi``, ``bank_friendly_form``), the
scratch K2's wrapper allocates per pair (``pairhmm_cuda.kernel_layout``),
and each kernel's bound (``utils/roofline.py``). K2 runs its MEA max-DP
from the far corner back; that order must equal the forward ``mea_score``
bit for bit on bf16-rounded posteriors (exact sums, so no tolerance),
which the last tests hold with an oracle of their own."""

import ml_dtypes
import numpy as np
import pytest
import torch

from dna_ldpc_tpu_torch.models import BlockedCode, build_rs_ldpc, dna_storage_blocked
from dna_ldpc_tpu_torch.ops import bp_cuda
from dna_ldpc_tpu_torch.ops.msa import pairhmm_cuda
from dna_ldpc_tpu_torch.ops.msa.align import mea_score
from dna_ldpc_tpu_torch.ops.msa.pairhmm import batch_post_ea
from dna_ldpc_tpu_torch.utils import roofline

torch.set_num_threads(1)


# ---- K1 ------------------------------------------------------------------

def test_k1_layout_deployed_code():
    lay = bp_cuda.kernel_layout(72, 256)
    assert lay.unrolled and lay.staged
    # check-major rows: 72 bf16 = 144 bytes = 9 words of 16; 72 pi bytes in a row of 80
    assert lay.tile_stride == 72 * 256 and lay.pi_row == 80 and lay.pi_stride == 256 * 80
    # two halves x two message-tile buffers, and the f32 posterior; pi rows come straight from global memory
    assert lay.smem_bytes == 4 * 36864 + 73728 == 221184 <= bp_cuda.SMEM_LIMIT


@pytest.mark.parametrize(
    "J,q,staged",
    [
        (12, 16, True),     # build_rs_ldpc(4, 12, 4)
        (32, 64, True),     # build_rs_ldpc(6, 32, 3)
        (64, 256, True),    # q = 256 exactly: one byte still holds q - 1; 14 N fits
        (70, 256, False),   # 14 N over the limit, 8 N under it: tiles read in place
        (20, 512, False),   # q > 256: 16 warps hide the loads, and a pi entry needs two bytes
        (28, 1024, False),  # the largest q
        (3, 5, True),       # J * q not a multiple of 8 or 16: strides round up
    ],
)
def test_k1_layout_generic_codes(J, q, staged):
    lay = bp_cuda.kernel_layout(J, q)
    n = J * q
    assert not lay.unrolled and lay.pi_row == 0 and lay.staged == staged
    assert lay.tile_stride % 8 == 0 and 0 <= lay.tile_stride - n < 8
    ring = 2 * (2 * lay.tile_stride + -(-n // 16) * 16)
    if staged:  # one-byte pi tiles beside the message tiles, whole 16-byte words
        assert lay.pi_stride % 16 == 0 and 0 <= lay.pi_stride - n < 16
        assert lay.smem_bytes == ring + 8 * n <= bp_cuda.SMEM_LIMIT
    else:  # the code's own int32 table; refused for q or for lack of room, not by choice
        assert lay.pi_stride == 4 * n and lay.smem_bytes == 8 * n
        assert q > 256 or ring + 8 * n > bp_cuda.SMEM_LIMIT


@pytest.mark.parametrize("J,q", [(2, 1025), (114, 256), (29057, 1)])
def test_k1_layout_refuses_what_no_instantiation_holds(J, q):
    with pytest.raises(ValueError):
        bp_cuda.kernel_layout(J, q)


def test_k1_layout_domain_is_eight_bytes_per_edge():
    """The unstaged instantiation needs the posterior and the backward
    buffer alone, so every code with 8 J q <= the limit is taken."""
    n_max = bp_cuda.SMEM_LIMIT // 8
    assert bp_cuda.kernel_layout(n_max // 256, 256).smem_bytes <= bp_cuda.SMEM_LIMIT
    assert bp_cuda.kernel_layout(n_max, 1).smem_bytes == 8 * n_max


def _unpack_pi(packed, layout, J, q):
    """Inverse of ``bp_cuda.pack_pi``: [G, J, q] int32."""
    G = packed.shape[0]
    if layout.pi_row:
        return packed.reshape(G, q, layout.pi_row)[:, :, :J].transpose(0, 2, 1).astype(np.int32)
    return packed[:, : J * q].reshape(G, J, q).astype(np.int32)


@pytest.mark.parametrize("code_args", [(4, 12, 4), (6, 32, 3), "deployed"])
def test_k1_pack_pi_round_trip(code_args):
    code = dna_storage_blocked() if code_args == "deployed" else BlockedCode.detect(build_rs_ldpc(*code_args))
    lay = bp_cuda.kernel_layout(code.J, code.q)
    packed = bp_cuda.pack_pi(code.pi, lay)
    assert packed.dtype == np.uint8 and packed.shape == (code.G, lay.pi_stride)
    np.testing.assert_array_equal(_unpack_pi(packed, lay, code.J, code.q), code.pi)
    g, j, r = code.G - 1, code.J - 1, code.q - 1
    if lay.unrolled:  # check-major: entry (g, j, r) is byte j of check r's row, the row's tail zero
        assert packed[g, r * lay.pi_row + j] == code.pi[g, j, r]
        assert not packed.reshape(code.G, code.q, lay.pi_row)[:, :, code.J:].any()
    else:  # entry (g, j, r) sits at byte j * q + r of coset g
        assert packed[g, j * code.q + r] == code.pi[g, j, r]


def test_k1_pack_pi_padding_and_codes_read_in_place():
    rng = np.random.default_rng(0)
    J, q = 3, 13  # 39 bytes a coset: padded to 48
    pi = np.stack([np.stack([rng.permutation(q) for _ in range(J)]) for _ in range(2)]).astype(np.int32)
    lay = bp_cuda.kernel_layout(J, q)
    assert lay.staged and lay.pi_stride == 48
    packed = bp_cuda.pack_pi(pi, lay)
    assert not packed[:, 39:].any()
    np.testing.assert_array_equal(_unpack_pi(packed, lay, J, q), pi)
    # q > 256 does not fit a byte: such a code runs in place on its own table, and nothing packs it
    J, q = 3, 300
    pi = np.stack([np.stack([rng.permutation(q) for _ in range(J)]) for _ in range(2)]).astype(np.int32)
    lay = bp_cuda.kernel_layout(J, q)
    assert not lay.staged and lay.pi_stride == pi[0].nbytes
    with pytest.raises(ValueError):
        bp_cuda.pack_pi(pi, lay)
    code = BlockedCode(n_checks=2 * q, n_vars=J * q, q=q, G=2, J=J, pi=pi, col_to_canonical=np.arange(J * q, dtype=np.int32))
    table = bp_cuda._packed_pi(code, lay, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.is_contiguous() and np.array_equal(table.numpy(), pi)


@pytest.mark.parametrize("code_args", [(4, 12, 4), (6, 32, 3), "deployed"])
def test_k1_bank_friendly_form_is_the_same_code(code_args):
    """Renamed checks and variables: every block is r -> r XOR constant (a
    warp's 32 consecutive checks touch 32 different banks), and the twin
    decodes the same external LLRs to the same words, failures included."""
    code = dna_storage_blocked() if code_args == "deployed" else BlockedCode.detect(build_rs_ldpc(*code_args))
    form = bp_cuda.bank_friendly_form(code)
    x = form.pi ^ np.arange(code.q)
    assert (x == x[:, :, :1]).all()
    assert sorted(form.col_to_canonical.tolist()) == list(range(code.n_vars))
    rng = np.random.default_rng(5)
    B, it = (2, 3) if code_args == "deployed" else (16, 12)
    llr = torch.from_numpy(rng.normal(1.0, 1.1, (B, code.n_vars)).astype(np.float32))
    a, b = bp_cuda.bp_decode_blocked_ref(code, llr, it), bp_cuda.bp_decode_blocked_ref(form, llr, it)
    for name in ("bits", "success", "unsat", "iterations"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not a.success.all()


def test_k1_bank_friendly_form_refuses_other_codes():
    """A blocked code that is not beta * u + a over GF(q) has no such form;
    the kernel then runs it under its own names."""
    rng = np.random.default_rng(1)
    q, G, J = 16, 2, 3
    pi = np.stack([np.stack([rng.permutation(q) for _ in range(J)]) for _ in range(G)]).astype(np.int32)
    code = BlockedCode(n_checks=G * q, n_vars=J * q, q=q, G=G, J=J, pi=pi,
                       col_to_canonical=np.arange(J * q, dtype=np.int32))
    assert bp_cuda.bank_friendly_form(code) is None
    code6 = BlockedCode(n_checks=12, n_vars=18, q=6, G=2, J=3, pi=pi[:, :, :6] % 6,
                        col_to_canonical=np.arange(18, dtype=np.int32))
    assert bp_cuda.bank_friendly_form(code6) is None  # q not a power of two


# ---- K2 ------------------------------------------------------------------

@pytest.mark.parametrize("Lmax,bands", [(160, 1), (97, 1), (1, 1), (191, 1), (192, 2), (1023, 6)])
def test_k2_kernel_layout(Lmax, bands):
    """Bands of 32 lanes x 6 rows; per band every lane has (Lmax + 32) steps
    (a read's columns and the wavefront's skew) of 6 rows; edge rows (two
    sweeps x five states) only where a read can span bands."""
    lay = pairhmm_cuda.kernel_layout(Lmax)
    assert lay["fm_stride"] == bands * (Lmax + 32) * 6 * 32
    assert lay["fm_stride"] >= (Lmax + 1) * (Lmax + 1)  # room for every cell of the largest box
    assert lay["edge_floats"] == (0 if bands == 1 else 10 * (Lmax + 1))


def test_k2_batches_are_sized_from_the_layout():
    """The MSA's K2 launches: scratch, f32 posterior and bf16 copy per pair
    under the byte budget (147,456 bytes of scratch at Lmax = 160)."""
    from dna_ldpc_tpu_torch.ops.msa import pairhmm

    assert pairhmm_cuda.kernel_layout(160)["fm_stride"] * 4 == 147456
    per_pair = 147456 + 160 * 160 * 6
    assert 6 < 47327 / (pairhmm.BUDGET_BYTES // per_pair) <= 7  # the 72,000-read trial's pairs in seven launches


@pytest.mark.parametrize("Lmax", [1024, 2000])
def test_k2_kernel_layout_refuses_long_reads(Lmax):
    with pytest.raises(ValueError):
        pairhmm_cuda.kernel_layout(Lmax)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _mea_score_backward(pb):
    """The kernel's phase 3 order: the MEA max-DP over a bf16-rounded
    posterior box [lx, ly], from the far corner back, in f32."""
    lx, ly = pb.shape
    U = np.zeros((lx + 2, ly + 2), np.float32)
    for i in range(lx, 0, -1):
        for j in range(ly, 0, -1):
            U[i, j] = max(np.float32(U[i + 1, j + 1] + np.float32(pb[i - 1, j - 1])), U[i + 1, j], U[i, j + 1])
    return np.float32(max(U[1, 1], np.float32(0.0))) if lx and ly else np.float32(0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2_backward_mea_equals_forward_on_bf16_values(seed):
    """Random bf16 posteriors in {0} U [0.01, 1] with many exact ties: the
    backward max-DP gives the forward one's f32 score exactly."""
    rng = np.random.default_rng(seed)
    lx, ly = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    pb = rng.random((lx, ly)).astype(np.float32)
    pb[pb < 0.01] = 0.0
    pb[rng.random((lx, ly)) < 0.5] = 0.0
    if seed == 2:
        pb = (rng.integers(0, 3, (lx, ly)) * 0.5).astype(np.float32)
    pb = _bf16(pb)
    assert _mea_score_backward(pb) == np.float32(mea_score(pb))


def test_k2_backward_mea_on_real_posteriors_and_empty_boxes():
    xs = ["ACGTACGTTAGC" * 4, "ACGT", "", "TTTTTTTTTT", "ACGTNACGT"]
    ys = ["ACGTACTTAGC" * 4, "AGGT", "ACG", "TTTTTTT", "ACGTAACGT"]
    post, ea, lx, ly, L = batch_post_ea(xs, ys, device="cpu")
    for p in range(len(xs)):
        box = _bf16(post[p, : lx[p], : ly[p]].numpy())
        assert _mea_score_backward(box) == ea[p].numpy(), p
    assert _mea_score_backward(np.zeros((0, 3), np.float32)) == 0.0


# ---- bounds ----------------------------------------------------------------

@pytest.mark.parametrize(
    "n_bytes,f32,mufu,want_ms,by",
    [
        (3.35e9, 0.0, 0.0, 1.0, "bytes"),
        (0.0, 67e9, 0.0, 1.0, "operations"),
        (0.0, 0.0, 16 * 132 * 1980e6 * 1e-3, 1.0, "operations"),
        (3.35e9, 2 * 67e9, 0.0, 2.0, "operations"),  # the larger of the two
        (2 * 3.35e9, 67e9, 0.0, 2.0, "bytes"),
    ],
)
def test_roofline_bound_is_the_larger_time(n_bytes, f32, mufu, want_ms, by):
    ms, what = roofline.bound_ms(n_bytes, f32, mufu)
    assert ms == pytest.approx(want_ms, rel=1e-12) and what == by


def test_roofline_k1_counts_the_iterations_that_ran():
    """Deployed code, 147,456 edges: 4 special-function operations per edge
    and iteration plus 2 at the start, at 16 per clock on 132 SMs."""
    fixed, by = roofline.k1_bound_ms(147456, 18432, [50] * 1024)
    assert by == "operations"
    assert fixed == pytest.approx(1e3 * 147456 * (4 * 50 * 1024 + 2 * 1024) / (16 * 132 * 1980e6), rel=1e-12)
    early, _ = roofline.k1_bound_ms(147456, 18432, [5] * 1000 + [50] * 24)
    assert early < fixed / 5
    slow, _ = roofline.k1_bound_ms(147456, 18432, [50] * 1024, sm_clock_mhz=990.0)
    assert slow == pytest.approx(2 * fixed, rel=1e-12)
    # no iteration ran: the two operations per edge of the start against LLRs in, bits out
    idle, by = roofline.k1_bound_ms(147456, 18432, [0] * 8)
    assert by == "operations" and idle > 8 * (5 * 18432 + 8) / 3.35e12 * 1e3


def test_roofline_k2_counts_the_boxes_and_mea_the_plane():
    one, by = roofline.k2_bound_ms([150], [147], 160)
    assert by == "operations"
    assert one == pytest.approx(1e3 * 37 * 151 * 148 / (16 * 132 * 1980e6), rel=1e-12)
    # an empty read has no cell to compute: only its zero posterior goes out
    empty, by = roofline.k2_bound_ms([0, 9], [7, 0], 160)
    assert by == "bytes" and empty == pytest.approx(1e3 * 2 * (320 + 8 + 4 * 160 * 160 + 4) / 3.35e12, rel=1e-12)
    both, _ = roofline.k2_bound_ms([150, 0], [147, 5], 160)
    assert both == one
    # mea_dp: of the plane only the wA x wB box can reach the path
    mea, by = roofline.mea_bound_ms([136] * 512, [135] * 512, 192)
    assert by == "bytes" and mea == pytest.approx(1e3 * 512 * (4 * 136 * 135 + 8 + 1920) / 3.35e12, rel=1e-12)
    assert mea < roofline.mea_bound_ms([192] * 512, [192] * 512, 192)[0]
    assert roofline.mea_bound_ms([0], [0], 192)[0] == pytest.approx(1e3 * (8 + 1920) / 3.35e12, rel=1e-12)
