"""Host-side beam container with the reference Lattice's competition rule:
at every step the candidate pool is {active hypotheses × every vocabulary
extension} ∪ {finished hypotheses}, and the best ``beam_size`` survive, so
a finished hypothesis must keep out-scoring the extensions to stay.

It keeps whole hypotheses (token tuple, score, finished) instead of the
reference's parent-pointer edges; sequences, scores and order are the same
(pinned against the reference's recorded trace in
tests/test_torch_reference_goldens.py).  The oracle of the searches in
decode/beam.py.  A copy of the JAX package's ``decode/lattice.py``.
"""

from __future__ import annotations

import numpy as np

from pytorch_kaldi_asr_tpu_torch.utils import constants


class Lattice:
    def __init__(self, max_length, beam_size):
        self.max_length = max_length
        self.beam_size = beam_size
        self.curr_length = 0
        # hypotheses: (tokens tuple incl BOS, cumulative log-prob, finished)
        self.hyps = [((constants.BOS,), 0.0, False)]
        self.done = False

    @property
    def num_curr_active(self):
        return sum(1 for h in self.hyps if not h[2])

    def active_sequences(self):
        """Token sequences of unfinished hypotheses, in beam order."""
        return [list(h[0]) for h in self.hyps if not h[2]]

    def advance(self, word_lk):
        """``word_lk``: [n_active, vocab] log-probs of the active hypotheses
        in beam order.  Returns True when decoding is finished."""
        active = [h for h in self.hyps if not h[2]]
        finished = [h for h in self.hyps if h[2]]
        if not active:
            return True
        word_lk = np.asarray(word_lk)
        assert word_lk.shape[0] == len(active)

        # the pool in the reference's order (active-major, word-minor, then
        # the finished), so ties break the same way
        candidates = []
        for i, (tokens, score, _) in enumerate(active):
            for w in range(word_lk.shape[1]):
                candidates.append((tokens + (w,), score + float(word_lk[i, w]),
                                   w == constants.EOS))
        candidates.extend(finished)

        order = np.argsort(-np.array([c[1] for c in candidates]),
                           kind="stable")
        self.hyps = [candidates[i] for i in order[: self.beam_size]]
        self.curr_length += 1

        if self.num_curr_active == 0 or self.curr_length > self.max_length:
            self.done = True
        return self.done

    def get_results(self, mode="all"):
        """(sequences, scores) in beam order; mode all, active or end."""
        if mode == "all":
            picked = self.hyps
        elif mode == "active":
            picked = [h for h in self.hyps if not h[2]]
        elif mode == "end":
            picked = [h for h in self.hyps if h[2]]
        else:
            raise ValueError(f"invalid mode {mode!r}")
        return [list(h[0]) for h in picked], [h[1] for h in picked]
