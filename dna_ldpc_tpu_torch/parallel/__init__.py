"""Multi-process BP over ``torch.distributed``: a (cw, graph) device mesh,
process-group set-up from torchrun's environment, and the sharded
decoders (codeword-axis data parallelism with the K1 kernel per rank,
check- and coset-sharded BP with one all-reduce per iteration)."""
