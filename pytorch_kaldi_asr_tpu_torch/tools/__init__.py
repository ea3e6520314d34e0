"""The recipes' host tools (the JAX package's ``tools/``): Kaldi CLI clones
(feat-to-len, compute-cmvn-stats, apply-cmvn, compute-wer, best_wer), data
dir filtering, WAV reading, fbank/MFCC extraction on the card, the
synthetic corpora and the shallow-fusion weight sweep; the lattice tools
(lattice-copy, lattice rescoring, consensus CTMs, ROVER, keyword search,
lattice rendering, CTM glue)."""
