"""The port's code-construction carry-overs against the JAX package's
originals: ``models/mod2.py``, ``models/sparse_lu.py``, the pchk / alist /
FASTA / FASTQ / ``.mat`` / ``index.txt`` codecs of ``utils/io_formats.py``,
``pipeline/ingest.py`` (its native overlap scoring against the numpy
twin), and the five code-construction subcommands of the CLI against the
JAX CLI's output files."""

import numpy as np
import pytest
import torch

from dna_ldpc_tpu import cli as j_cli
from dna_ldpc_tpu.models import mod2 as j_mod2
from dna_ldpc_tpu.models import sparse_lu as j_lu
from dna_ldpc_tpu.models.rs_ldpc import build_rs_ldpc
from dna_ldpc_tpu.pipeline import ingest as j_ingest
from dna_ldpc_tpu.utils import io_formats as j_io
from dna_ldpc_tpu_torch import cli as t_cli
from dna_ldpc_tpu_torch import native_lib
from dna_ldpc_tpu_torch.models import mod2 as t_mod2
from dna_ldpc_tpu_torch.models import sparse_lu as t_lu
from dna_ldpc_tpu_torch.pipeline import ingest as t_ingest
from dna_ldpc_tpu_torch.utils import io_formats as t_io

# The suite runs in several worker processes that share the cores: one
# intra-op thread per process keeps OpenMP from oversubscribing them.
torch.set_num_threads(1)


def random_matrix(seed, m=20, n=45, dependent=True):
    rng = np.random.default_rng(seed)
    dense = (rng.random((m, n)) < 0.2).astype(np.uint8)
    if dependent:
        dense[0] = dense[1] ^ dense[2]
    return j_io.SparseBinaryMatrix.from_coo(m, n, *np.nonzero(dense))


MATRICES = [lambda: build_rs_ldpc(4, 8, 4), lambda: build_rs_ldpc(3, 6, 3), lambda: random_matrix(7)]


@pytest.mark.parametrize("make", MATRICES)
def test_mod2_matches_jax(make):
    dense = make().to_dense()
    np.testing.assert_array_equal(t_mod2.pack_rows(dense), j_mod2.pack_rows(dense))
    np.testing.assert_array_equal(t_mod2.unpack_rows(j_mod2.pack_rows(dense), dense.shape[1]), dense)
    a, b = t_mod2.eliminate(dense), j_mod2.eliminate(dense)
    for f in ("rre", "pivot_cols", "rank"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert t_mod2.rank(dense) == j_mod2.rank(dense)
    np.testing.assert_array_equal(t_mod2.nullspace_basis(dense), j_mod2.nullspace_basis(dense))
    ga, gb = t_mod2.make_generator(dense), j_mod2.make_generator(dense)
    for f in ("n", "info_cols", "parity_cols", "parity_map"):
        np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f), err_msg=f)
    msg = np.random.default_rng(1).integers(0, 2, (5, ga.k)).astype(np.uint8)
    np.testing.assert_array_equal(ga.encode(msg), gb.encode(msg))
    cw = t_mod2.random_codewords(dense, 6, np.random.default_rng(3))
    np.testing.assert_array_equal(cw, j_mod2.random_codewords(dense, 6, np.random.default_rng(3)))
    assert not ((dense.astype(np.int64) @ cw.T.astype(np.int64)) % 2).any()


@pytest.mark.parametrize("make", MATRICES)
def test_sparse_lu_matches_jax(make):
    H = make()
    a, b = t_lu.lu_decompose(H), j_lu.lu_decompose(H)
    for f in ("n", "rank", "pivot_cols", "info_cols", "row_order", "l_ops", "B_packed", "dependent_rows"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert [list(r) for r in a.u_rows] == [list(r) for r in b.u_rows]
    msgs = np.random.default_rng(4).integers(0, 2, (6, len(a.info_cols))).astype(np.uint8)
    cw = t_lu.sparse_encode(a, msgs)
    np.testing.assert_array_equal(cw, j_lu.sparse_encode(b, msgs))
    np.testing.assert_array_equal(t_lu.dense_encode(H, msgs), j_lu.dense_encode(H, msgs))
    np.testing.assert_array_equal(t_lu.mixed_encode(a, msgs), j_lu.mixed_encode(b, msgs))
    assert not H.mulvec(cw).any()


def test_pchk_and_alist_codecs_match_jax(tmp_path):
    H = build_rs_ldpc(4, 8, 4)
    for tw, jw, tr, jr, ext in ((t_io.write_pchk, j_io.write_pchk, t_io.read_pchk, j_io.read_pchk, "pchk"),
                                (t_io.write_alist, j_io.write_alist, t_io.read_alist, j_io.read_alist, "alist")):
        tp, jp = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
        tw(str(tp), H)
        jw(str(jp), H)
        assert tp.read_bytes() == jp.read_bytes()
        a, b = tr(str(jp)), jr(str(jp))
        assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols) == (H.n_rows, H.n_cols)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.indptr, H.indptr)
    (tmp_path / "bad").write_bytes(b"\x00" * 12)
    with pytest.raises(ValueError, match="bad magic"):
        t_io.read_pchk(str(tmp_path / "bad"))


def test_fasta_fastq_mat_index_codecs_match_jax(tmp_path):
    recs = [("r1", "ACGT" * 50), ("r2 extra", "GG"), ("r3", "")]
    for wrap in (None, 80):
        t_io.write_fasta(str(tmp_path / "t.fa"), recs, wrap)
        j_io.write_fasta(str(tmp_path / "j.fa"), recs, wrap)
        assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
        assert t_io.read_fasta(str(tmp_path / "j.fa")) == j_io.read_fasta(str(tmp_path / "j.fa"))
    (tmp_path / "r.fq").write_text("@a\nACGT\n+\nIIII\n@b\nGG\n+\n#5\n")
    assert t_io.read_fastq(str(tmp_path / "r.fq")) == j_io.read_fastq(str(tmp_path / "r.fq"))
    rng = np.random.default_rng(5)
    dec = rng.integers(0, 2, (7, 16)).astype(np.uint8)
    cn = np.array([0, 1, -1, 2, 0, 3, -1])
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t_io.write_index_mats(str(tmp_path / "t"), dec, cn)
    j_io.write_index_mats(str(tmp_path / "j"), dec, cn)
    for d in ("t", "j"):
        for read in (t_io.read_index_mats, j_io.read_index_mats):
            got_dec, got_cn = read(str(tmp_path / d))
            np.testing.assert_array_equal(got_dec, dec)
            np.testing.assert_array_equal(got_cn, cn)
    bits = rng.integers(0, 2, (5, 32))
    t_io.write_index_txt(str(tmp_path / "t.txt"), bits)
    j_io.write_index_txt(str(tmp_path / "j.txt"), bits)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    np.testing.assert_array_equal(t_io.read_index_txt(str(tmp_path / "j.txt")), j_io.read_index_txt(str(tmp_path / "j.txt")))


def _read_pairs(seed, n=200):
    """Paired reads of random fragments: overlaps of several lengths,
    substitutions, N bases, and some pairs that do not overlap."""
    rng = np.random.default_rng(seed)
    comp = str.maketrans("ACGTN", "TGCAN")
    r1, q1, r2, q2 = [], [], [], []
    for i in range(n):
        frag = "".join(rng.choice(list("ACGT"), int(rng.integers(60, 140))))
        l1, l2 = int(rng.integers(30, 80)), int(rng.integers(30, 80))
        a, b = list(frag[:l1]), list(frag[-l2:].translate(comp)[::-1])
        if i % 7 == 0:
            b = list("".join(rng.choice(list("ACGT"), l2)))  # unrelated mate
        for s in (a, b):
            for k in rng.choice(len(s), int(rng.integers(0, 3)), replace=False):
                s[k] = "ACGTN"[int(rng.integers(0, 5))]
        r1.append("".join(a))
        r2.append("".join(b))
        q1.append("".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(a))))
        q2.append("".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(b))))
    return r1, q1, r2, q2


@pytest.mark.parametrize("min_overlap", [10, 20])
def test_ingest_merge_matches_jax(min_overlap):
    r1, q1, r2, q2 = _read_pairs(min_overlap)
    a = t_ingest.merge_pairs(r1, q1, r2, q2, min_overlap=min_overlap)
    b = j_ingest.merge_pairs(r1, q1, r2, q2, min_overlap=min_overlap)
    assert a.merged == b.merged and a.merged_qual == b.merged_qual
    np.testing.assert_array_equal(a.overlap, b.overlap)
    np.testing.assert_array_equal(a.mismatches, b.mismatches)
    assert 0 < a.ok.sum() < len(r1)
    assert t_ingest.merged_read_and_qline(a) == j_ingest.merged_read_and_qline(b)
    # the native overlap scoring against its numpy twin
    L = max(max(map(len, r1)), max(map(len, r2)))
    l1 = np.array([len(s) for s in r1], np.int64)
    l2 = np.array([len(s) for s in r2], np.int64)
    m1 = t_ingest.seqs_to_matrix(r1, pad=L)
    m2 = t_ingest.reverse_complement_batch(t_ingest.seqs_to_matrix(r2, pad=L), l2)
    native = native_lib.merge_overlap_batch_native(m1, m2, l1, l2, min_overlap)
    twin = t_ingest.score_overlaps_ref(m1, m2, l1, l2, min_overlap)
    for x, y in zip(native, twin):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        native_lib.merge_overlap_batch_native(m1, m2[:5], l1, l2, min_overlap)
    empty = t_ingest.merge_pairs([], [], [], [])
    assert empty.merged == [] and len(empty.overlap) == 0


def test_cli_code_tools_match_jax(tmp_path):
    """rs-ldpc -> alist-to-pchk -> pchk-to-alist -> make-gen -> encode, each
    run by both CLIs: the same files (the generator's fields, the
    codewords), the alist back byte-equal, codewords that satisfy H."""
    out = {}
    for name, main in (("jax", j_cli.main), ("port", t_cli.main)):
        d = tmp_path / name
        d.mkdir()
        f = lambda s: str(d / s)
        assert main(["rs-ldpc", "4", "8", "4", f("code.alist")]) == 0
        assert main(["alist-to-pchk", f("code.alist"), f("code.pchk")]) == 0
        assert main(["pchk-to-alist", f("code.pchk"), f("back.alist")]) == 0
        assert main(["make-gen", f("code.pchk"), f("gen.npz"), "--method", "mixed"]) == 0
        k = len(np.load(f("gen.npz"))["info_cols"])
        np.savetxt(f("msgs.txt"), np.random.default_rng(6).integers(0, 2, (4, k)), fmt="%d")
        for method in ("sparse", "dense"):
            assert main(["encode", f("code.pchk"), f("msgs.txt"), f(f"cw_{method}.txt"), "--method", method]) == 0
        out[name] = d
    j, t = out["jax"], out["port"]
    for name in ("code.alist", "code.pchk", "back.alist", "cw_sparse.txt", "cw_dense.txt"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    assert (t / "back.alist").read_bytes() == (t / "code.alist").read_bytes()
    tg, jg = np.load(t / "gen.npz"), np.load(j / "gen.npz")
    assert sorted(tg.files) == sorted(jg.files)
    for key in tg.files:
        np.testing.assert_array_equal(tg[key], jg[key], err_msg=key)
    H = t_io.read_pchk(str(t / "code.pchk"))
    cw = np.loadtxt(t / "cw_sparse.txt", dtype=np.uint8, ndmin=2)
    assert cw.shape == (4, 128) and not H.mulvec(cw).any()
