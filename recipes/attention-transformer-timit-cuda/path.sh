#!/bin/bash
# Environment glue for the recipe: REPO_ROOT is detected relative to this
# file, and local/ comes first on the paths, so a copy of a port module in
# local/ shadows the package for one experiment.
RECIPE_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_ROOT="$(cd "$RECIPE_DIR/../.." && pwd)"
export PYTHONPATH="$RECIPE_DIR/local:$REPO_ROOT:$PYTHONPATH"
export PATH="$RECIPE_DIR/local:$PATH"
# convenience alias for the port's CLI tools
pka() { python3 -m "pytorch_kaldi_asr_tpu_torch.$@"; }
export -f pka 2>/dev/null || true
