"""Record and pin golden arks from a FOREIGN Kaldi writer: the port's copy
of the JAX package's ``tools/record_foreign_goldens.py``, over the port's
``io/kaldi_io``.

The port's reader has only read bytes from its own writer and the JAX
package's (no Kaldi binaries and no kaldi-io-for-python install are at
hand).  This tool makes the check against a foreign writer one command for
the day one is reachable::

    # on a machine with Kaldi and/or `pip install kaldi_io`:
    python -m pytorch_kaldi_asr_tpu_torch.tools.record_foreign_goldens \
        record --out_dir goldens/foreign
    # then (same or any machine), pin the port's reader to the recording:
    python -m pytorch_kaldi_asr_tpu_torch.tools.record_foreign_goldens \
        check --out_dir goldens/foreign

``record`` probes, in order:

1. Kaldi binaries (``$KALDI_ROOT/src/featbin/copy-feats`` or ``copy-feats``
   on $PATH): deterministic float32 matrices are written as TEXT arks (a
   trivially-correct producer format) and copy-feats converts them to
   binary FM arks and compressed CM arks (``--compress=true``,
   ``--compression-method={2,4,6}`` -> CM1/CM2/CM3 wire formats).
2. The kaldi-io-for-python package (top-level ``import kaldi_io``, not
   either package's ``io.kaldi_io``): writes the same matrices with
   ``kaldi_io.write_mat`` (binary FM + per-entry scp offsets).

Everything recorded lands in ``out_dir``: the foreign ``.ark``/``.scp``
bytes, the expected matrices (``expected.npz``), and a ``manifest.json``
describing the producer.  ``check`` re-reads every recorded ark with
``io/kaldi_io`` and pins:

- FM (uncompressed) reads EXACTLY equal to the expected float32 matrices;
- CM1/CM2/CM3 reads equal to within the compression's own quantization
  error bound (and, when the foreign python reader is importable, exactly
  equal to what the FOREIGN reader decodes from the same bytes);
- scp offset reads (the native core's) exactly equal to ark-sequential
  reads (the Python readers'): the core gives the Python readers' values
  bit for bit.

``--self_test`` substitutes the port's OWN writer as the producer, so the
record/check plumbing itself stays covered by the tests
(tests/test_torch_native_host.py).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup

# deterministic corpus: shapes cover odd columns (CM3 byte padding), short
# and long rows, and values spanning sign/magnitude ranges
_SHAPES = [(7, 13), (1, 40), (211, 40), (35, 1), (96, 23)]


def _expected_mats(seed=20260820):
    rng = np.random.default_rng(seed)
    mats = {}
    for i, (r, c) in enumerate(_SHAPES):
        m = (rng.standard_normal((r, c)) * (10.0 ** (i % 3))).astype(
            np.float32)
        mats[f"utt{i:03d}"] = m
    return mats


def _write_text_ark(path, mats):
    """Text-format ark: the producer format simple enough to be correct by
    inspection — what we feed the foreign converter."""
    with open(path, "w") as f:
        for key, m in mats.items():
            f.write(f"{key}  [\n")
            for row in m:
                f.write("  " + " ".join(repr(float(v)) for v in row) + "\n")
            f.write(" ]\n")


def _find_kaldi_copy_feats():
    root = os.environ.get("KALDI_ROOT")
    if root:
        cand = os.path.join(root, "src", "featbin", "copy-feats")
        if os.access(cand, os.X_OK):
            return cand
    return shutil.which("copy-feats")


def _import_foreign_kaldi_io():
    """kaldi-io-for-python, if installed (must not be this package)."""
    try:
        import kaldi_io as foreign  # noqa: F401
    except ImportError:
        return None
    if getattr(foreign, "__file__", "") and \
            "pytorch_kaldi_asr_tpu" in foreign.__file__:
        return None
    return foreign if hasattr(foreign, "write_mat") else None


def record(out_dir, self_test=False):
    """Record foreign-producer arks + expected matrices into out_dir.
    Returns the manifest dict (also written to manifest.json)."""
    os.makedirs(out_dir, exist_ok=True)
    mats = _expected_mats()
    np.savez(os.path.join(out_dir, "expected.npz"), **mats)
    manifest = {"producers": [], "arks": []}

    copy_feats = None if self_test else _find_kaldi_copy_feats()
    foreign_io = None if self_test else _import_foreign_kaldi_io()

    if copy_feats:
        text_ark = os.path.join(out_dir, "source.txt.ark")
        _write_text_ark(text_ark, mats)
        jobs = [("kaldi_fm.ark", ["--binary=true"]),
                ("kaldi_cm1.ark", ["--compress=true",
                                   "--compression-method=2"]),
                ("kaldi_cm2.ark", ["--compress=true",
                                   "--compression-method=4"]),
                ("kaldi_cm3.ark", ["--compress=true",
                                   "--compression-method=6"])]
        for name, flags in jobs:
            ark = os.path.join(out_dir, name)
            scp = ark[:-4] + ".scp"
            subprocess.run(
                [copy_feats, *flags, f"ark,t:{text_ark}",
                 f"ark,scp:{ark},{scp}"],
                check=True, capture_output=True)
            manifest["arks"].append(
                {"ark": name, "scp": os.path.basename(scp),
                 "producer": "kaldi:copy-feats",
                 "compressed": "cm" in name})
        manifest["producers"].append(
            {"kind": "kaldi", "copy_feats": copy_feats})

    if foreign_io is not None:
        ark = os.path.join(out_dir, "kaldiio_py_fm.ark")
        with open(ark, "wb") as f:
            offsets = {}
            for key, m in mats.items():
                offsets[key] = f.tell() + len(key) + 1
                foreign_io.write_mat(f, m, key=key)
        with open(ark[:-4] + ".scp", "w") as f:
            for key, off in offsets.items():
                f.write(f"{key} {ark}:{off}\n")
        manifest["arks"].append(
            {"ark": os.path.basename(ark),
             "scp": os.path.basename(ark[:-4] + ".scp"),
             "producer": "kaldi-io-for-python", "compressed": False})
        manifest["producers"].append(
            {"kind": "kaldi-io-for-python",
             "file": getattr(foreign_io, "__file__", "?")})

    if self_test:
        # the port's own writer stands in for the foreign producer so the
        # record/check harness itself stays covered by the tests (all four
        # wire formats the check knows how to bound)
        for name, compress in [("selftest_fm.ark", False),
                               ("selftest_cm.ark", True),
                               ("selftest_cm1.ark", "CM"),
                               ("selftest_cm3.ark", "CM3")]:
            ark = os.path.join(out_dir, name)
            scp = ark[:-4] + ".scp"
            with kaldi_io.open_writer(f"ark,scp:{ark},{scp}",
                                      compress=compress) as w:
                for key, m in mats.items():
                    w.write(key, m)
            manifest["arks"].append(
                {"ark": name, "scp": os.path.basename(scp),
                 "producer": "self", "compressed": compress})
        manifest["producers"].append({"kind": "self"})

    if not manifest["producers"]:
        raise SystemExit(
            "no foreign producer reachable: set $KALDI_ROOT (copy-feats) "
            "or `pip install kaldi_io`, then re-run.")
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def check(out_dir):
    """Pin io/kaldi_io.py reads against a recorded goldens dir.  Raises
    AssertionError on any mismatch; returns #arks checked."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    expected = dict(np.load(os.path.join(out_dir, "expected.npz")))
    foreign_io = _import_foreign_kaldi_io()
    n = 0
    for entry in manifest["arks"]:
        ark = os.path.join(out_dir, entry["ark"])
        got = {k: m for k, m in kaldi_io.read_mat_ark(ark)}
        assert sorted(got) == sorted(expected), \
            f"{entry['ark']}: keys {sorted(got)} != {sorted(expected)}"
        for key, exp in expected.items():
            m = got[key]
            assert m.shape == exp.shape, (entry["ark"], key, m.shape)
            if entry["compressed"]:
                # bound the error by each CM format's own quantization
                # step: CM2/selftest_cm = uint16 over the global range;
                # CM3 = uint8 over the global range; CM1 = uint8 on a
                # per-column piecewise percentile scale whose worst
                # segment can approach the full span over ~63 codes
                span = float(exp.max() - exp.min())
                name = entry["ark"].lower()
                if "cm1" in name:
                    step = span / 32.0
                elif "cm3" in name:
                    step = span / 255.0
                else:  # cm2 / selftest_cm (our CM2 writer)
                    step = span / 65535.0 * 4
                err = float(np.abs(m - exp).max())
                assert err <= max(step * 1.5, 1e-5), \
                    (entry["ark"], key, err, step)
            else:
                assert np.array_equal(m, exp), \
                    (entry["ark"], key, "FM read not byte-exact")
        # scp offset reads (the native core) equal sequential ark reads
        # (the Python readers), every matrix kind
        scp = os.path.join(out_dir, entry["scp"])
        if os.path.exists(scp):
            for key, m in kaldi_io.read_mat_scp(scp):
                assert m.dtype == got[key].dtype and \
                    np.array_equal(m, got[key]), (scp, key)
        # cross-check: the FOREIGN reader decodes the same bytes to the
        # same values as ours (when importable)
        if foreign_io is not None and hasattr(foreign_io, "read_mat_ark"):
            for key, m in foreign_io.read_mat_ark(ark):
                assert np.allclose(got[key], m, atol=0, rtol=0), \
                    (entry["ark"], key, "disagrees with foreign reader")
        n += 1
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=["record", "check"])
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--self_test", action="store_true",
                        help="use the port's own writer as the producer "
                             "(covers the harness; not a foreign check)")
    opt = parser.parse_args(argv)
    if opt.mode == "record":
        manifest = record(opt.out_dir, self_test=opt.self_test)
        kinds = [p["kind"] for p in manifest["producers"]]
        print(f"[record_foreign_goldens] recorded {len(manifest['arks'])} "
              f"arks from producers {kinds} into {opt.out_dir}")
    else:
        n = check(opt.out_dir)
        print(f"[record_foreign_goldens] OK: {n} arks pinned")
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
