// Levenshtein edit distance with its insertion, deletion and substitution
// counts: the port's copy of the JAX package's native/src/edit_distance.cc,
// the core of score/wer.py's levenshtein_alignment and of pka-compute-wer.
// Ties go diagonal, then up (deletion), then left (insertion), as in
// score/wer.py's numpy DP, so every count equals the DP's, not only the
// total.  Tokens come as int32 ids (the caller maps words in order of first
// sight), so the DP is integer work.

#include <cstdint>
#include <vector>

extern "C" {

// ref/hyp: int32 token id arrays. Fills err/ins/del/sub. Returns 0.
int pka_edit_distance(const int32_t* ref, int32_t ref_len,
                      const int32_t* hyp, int32_t hyp_len, int32_t* err,
                      int32_t* ins, int32_t* del, int32_t* sub) {
  if (ref_len == 0) {
    *err = *ins = hyp_len;
    *del = *sub = 0;
    return 0;
  }
  if (hyp_len == 0) {
    *err = *del = ref_len;
    *ins = *sub = 0;
    return 0;
  }
  struct Cell {
    int32_t total, ins, del, sub;
  };
  std::vector<Cell> prev(hyp_len + 1), cur(hyp_len + 1);
  for (int32_t j = 0; j <= hyp_len; ++j) prev[j] = {j, j, 0, 0};
  for (int32_t i = 1; i <= ref_len; ++i) {
    cur[0] = {i, 0, i, 0};
    for (int32_t j = 1; j <= hyp_len; ++j) {
      const int match = (ref[i - 1] == hyp[j - 1]) ? 0 : 1;
      const int32_t diag = prev[j - 1].total + match;
      const int32_t up = prev[j].total + 1;
      const int32_t left = cur[j - 1].total + 1;
      if (diag <= up && diag <= left) {
        cur[j] = {diag, prev[j - 1].ins, prev[j - 1].del,
                  prev[j - 1].sub + match};
      } else if (up <= left) {
        cur[j] = {up, prev[j].ins, prev[j].del + 1, prev[j].sub};
      } else {
        cur[j] = {left, cur[j - 1].ins + 1, cur[j - 1].del, cur[j - 1].sub};
      }
    }
    prev.swap(cur);
  }
  *err = prev[hyp_len].total;
  *ins = prev[hyp_len].ins;
  *del = prev[hyp_len].del;
  *sub = prev[hyp_len].sub;
  return 0;
}

}  // extern "C"
