"""Code construction and decoding tables (numpy), plus torch views."""

from .blocked import BlockedCode, dna_storage_blocked  # noqa: F401
from .codebook import codebook_lookup, codebook_rank, index_codebook  # noqa: F401
from .ldpc_graph import LdpcGraph, graph_from_reference  # noqa: F401
from .rs_ldpc import build_rs_ldpc, dna_storage_pchk  # noqa: F401
