"""Trial read-back: reads -> LLR table -> annealed BP decode."""
