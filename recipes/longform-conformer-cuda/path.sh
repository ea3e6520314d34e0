#!/bin/bash
# Environment glue, the TIMIT port recipe's layout: local/ first on the
# paths, then the repository.
RECIPE_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_ROOT="$(cd "$RECIPE_DIR/../.." && pwd)"
export PYTHONPATH="$RECIPE_DIR/local:$REPO_ROOT:$PYTHONPATH"
export PATH="$RECIPE_DIR/local:$PATH"
pka() { python3 -m "pytorch_kaldi_asr_tpu_torch.$@"; }
export -f pka 2>/dev/null || true
