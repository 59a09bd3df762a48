"""Command-line interface of the port: the ``decode`` and ``simulate``
subcommands of ``dna_ldpc_tpu/cli.py``, with the same arguments and report
files, plus ``--device`` (default ``cuda``), and its five host-only
code-construction tools (``rs-ldpc``, ``alist-to-pchk``, ``pchk-to-alist``,
``make-gen``, ``encode``) with the same arguments and output files:

    python -m dna_ldpc_tpu_torch.cli decode --rs 72000 --start 0 --end 10 \\
        --epsil 0.02 --data-dir <dir with 72000_RS_<t>.txt / _Q_<t>.txt> \\
        --codeword-dir <dir with codeword_n18432_m1860_*.txt>
    python -m dna_ldpc_tpu_torch.cli simulate --oligos final_DNA.txt ...
    python -m dna_ldpc_tpu_torch.cli rs-ldpc 8 72 8 code.alist
    python -m dna_ldpc_tpu_torch.cli encode code.pchk messages.txt codewords.txt

``decode`` reads per-trial read/quality files, ``simulate`` draws trials
from an oligo pool; both decode each trial on ``--device`` and write
``o_/x_<rs>_<trial>_<eps>_result.txt`` report files. A device that is not
present raises: nothing silently runs on the CPU. The exit code is 1 if a
trial failed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from .pipeline.simulate import ChannelModel
from .utils.device import DEFAULT_DEVICE, require_device


def _load_codewords(codeword_dir: str) -> np.ndarray:
    from .utils.io_formats import read_vector

    return np.stack(
        [
            read_vector(os.path.join(codeword_dir, f"codeword_n18432_m1860_{i}.txt"))
            for i in range(1, 273)
        ]
    )


def _config(args):
    from .pipeline.decode import TrialConfig

    return TrialConfig(epsil=args.epsil, max_iter=args.max_iter, device=str(require_device(args.device)))


def _report(result, args, trial: int) -> int:
    from .pipeline.report import write_result

    path = write_result(result, args.rs, trial, args.epsil, args.out_dir)
    status = "success" if result.success else "FAILURE"
    print(
        f"trial {trial}: {status}; first {272 - len(result.fail_first)}/272, "
        f"anneal iters {result.n_anneal_iters}; report -> {path}"
    )
    return 0 if result.success else 1


def cmd_decode(args) -> int:
    from .pipeline.decode import decode_trial
    from .utils.io_formats import read_lines

    config = _config(args)
    codewords = _load_codewords(args.codeword_dir)
    rc = 0
    for trial in range(args.start, args.end):
        reads_path = os.path.join(args.data_dir, f"{args.rs}_RS_{trial}.txt")
        quals_path = os.path.join(args.data_dir, f"{args.rs}_RS_Q_{trial}.txt")
        if not os.path.exists(reads_path):
            print("************** No random sampling file! **************")
            break
        print("************** Read random sampling file! **************")
        result = decode_trial(read_lines(reads_path), read_lines(quals_path), codewords, config)
        rc |= _report(result, args, trial)
    return rc


def cmd_simulate(args) -> int:
    from .pipeline.decode import decode_trial
    from .pipeline.simulate import load_oligos, simulate_reads

    config = _config(args)
    codewords = _load_codewords(args.codeword_dir)
    oligos = load_oligos(args.oligos)
    channel = ChannelModel(substitution=args.sub_rate, insertion=args.ins_rate, deletion=args.del_rate)
    rc = 0
    for trial in range(args.start, args.end):
        reads, quals = simulate_reads(oligos, args.rs, channel, seed=args.seed + trial)
        rc |= _report(decode_trial(reads, quals, codewords, config), args, trial)
    return rc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dna-ldpc-tpu-torch", description="Decoding of the sequenced DNA data (PyTorch/CUDA)"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--rs", type=int, default=70000, help="Random sampling number")
    common.add_argument("--start", type=int, default=0, help="Iteration start number")
    common.add_argument("--end", type=int, default=10, help="Iteration end number")
    common.add_argument("--epsil", type=float, default=0.03, help="Epsilon value")
    common.add_argument("--max-iter", type=int, default=200, help="BP iterations")
    common.add_argument("--codeword-dir", default=".", help="codeword_n18432_m1860_* dir")
    common.add_argument("--out-dir", default=".", help="where to write result files")
    common.add_argument("--device", default=DEFAULT_DEVICE, help="torch device the trial runs on")

    d = sub.add_parser("decode", parents=[common], help="decode sampled-read trial files")
    d.add_argument("--data-dir", default=".", help="dir with <rs>_RS_<t>.txt files")
    d.set_defaults(fn=cmd_decode)

    s = sub.add_parser("simulate", parents=[common], help="simulate + decode trials")
    s.add_argument("--oligos", required=True, help="encoded oligo pool (final_DNA.txt)")
    _ch = ChannelModel()
    s.add_argument("--sub-rate", type=float, default=_ch.substitution)
    s.add_argument("--ins-rate", type=float, default=_ch.insertion)
    s.add_argument("--del-rate", type=float, default=_ch.deletion)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_simulate)

    # --- standalone code-construction / format tools ------------------------
    # (RS_LDPC.exe, alist-to-pchk.cpp, make_gen.cpp equivalents)
    r = sub.add_parser("rs-ldpc", help="construct an RS-LDPC alist (RS_LDPC.exe)")
    r.add_argument("s", type=int, help="field exponent (GF(2^s))")
    r.add_argument("rho", type=int, help="row weight")
    r.add_argument("gamma", type=int, help="column weight")
    r.add_argument("out", help="output .alist path")
    r.set_defaults(fn=cmd_rs_ldpc)

    a2p = sub.add_parser("alist-to-pchk", help="convert alist to binary pchk")
    a2p.add_argument("alist")
    a2p.add_argument("pchk")
    a2p.set_defaults(fn=cmd_alist_to_pchk)

    p2a = sub.add_parser("pchk-to-alist", help="convert binary pchk to alist")
    p2a.add_argument("pchk")
    p2a.add_argument("alist")
    p2a.set_defaults(fn=cmd_pchk_to_alist)

    mg = sub.add_parser("make-gen", help="build a generator from a pchk (make_gen)")
    mg.add_argument("pchk")
    mg.add_argument("gen", help="output .npz generator")
    mg.add_argument("--method", choices=["sparse", "dense", "mixed"], default="sparse")
    mg.set_defaults(fn=cmd_make_gen)

    e = sub.add_parser("encode", help="systematically encode messages (enc)")
    e.add_argument("pchk")
    e.add_argument("messages", help="text file: one space-separated message per line")
    e.add_argument("out", help="output codeword file")
    e.add_argument("--method", choices=["sparse", "dense", "mixed"], default="sparse")
    e.set_defaults(fn=cmd_encode)
    return p


def cmd_rs_ldpc(args) -> int:
    from .models.rs_ldpc import build_rs_ldpc
    from .utils.io_formats import write_alist

    H = build_rs_ldpc(args.s, args.rho, args.gamma)
    write_alist(args.out, H)
    print(f"wrote {H.n_rows} x {H.n_cols} alist ({H.nnz} edges) -> {args.out}")
    return 0


def cmd_alist_to_pchk(args) -> int:
    from .utils.io_formats import read_alist, write_pchk

    write_pchk(args.pchk, read_alist(args.alist))
    return 0


def cmd_pchk_to_alist(args) -> int:
    from .utils.io_formats import read_pchk, write_alist

    write_alist(args.alist, read_pchk(args.pchk))
    return 0


def cmd_make_gen(args) -> int:
    from .models.sparse_lu import lu_decompose
    from .utils.io_formats import read_pchk

    H = read_pchk(args.pchk)
    lu = lu_decompose(H)
    np.savez_compressed(
        args.gen,
        method=args.method,
        n=lu.n,
        rank=lu.rank,
        pivot_cols=lu.pivot_cols,
        info_cols=lu.info_cols,
        l_ops=lu.l_ops,
        u_rows=np.array(
            [len(r) for r in lu.u_rows] + [v for r in lu.u_rows for v in r],
            dtype=np.int64,
        ),
        B_packed=lu.B_packed,
        row_order=lu.row_order,
        dependent_rows=lu.dependent_rows,
    )
    print(f"generator: n={lu.n} k={len(lu.info_cols)} rank={lu.rank} -> {args.gen}")
    return 0


def cmd_encode(args) -> int:
    from .models.sparse_lu import dense_encode, lu_decompose, sparse_encode
    from .utils.io_formats import read_pchk

    H = read_pchk(args.pchk)
    msgs = np.loadtxt(args.messages, dtype=np.uint8, ndmin=2)
    if args.method == "dense":
        cw = dense_encode(H, msgs)
    else:
        cw = sparse_encode(lu_decompose(H), msgs)
    np.savetxt(args.out, cw, fmt="%d")
    print(f"encoded {len(msgs)} messages -> {args.out}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
