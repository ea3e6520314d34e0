"""Kaldi data-directory utilities.

Python equivalents of the vendored ``kaldi/utils`` script layer the reference
ships (SURVEY.md §2b "Data-dir management"): consistency validation/fixing,
subsetting, splitting, combining, and the small table filters
(filter_scp/sym2int/int2sym/utt2spk↔spk2utt/apply_map/shuffle_list).

A "data dir" is a directory of aligned text tables keyed by utterance
(feats.scp, text, utt2spk, wav.scp, feats.length, cmvn.scp, ...) plus
spk2utt; the invariant the tooling enforces is: same key set everywhere,
sorted, no duplicates."""

from __future__ import annotations

import os
import random
import shutil

from pytorch_kaldi_asr_tpu_torch.utils.logging import info

UTT_TABLES = ("feats.scp", "text", "utt2spk", "wav.scp", "feats.length",
              "segments", "vad.scp")
SPK_TABLES = ("spk2utt", "cmvn.scp", "spk2gender")


def read_table(path):
    """key → rest-of-line (str, possibly empty)."""
    table = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(None, 1)
            if parts:
                table[parts[0]] = parts[1] if len(parts) > 1 else ""
    return table


def write_table(path, table):
    with open(path, "w", encoding="utf-8") as f:
        for key in sorted(table):
            value = table[key]
            f.write(f"{key} {value}\n" if value != "" else f"{key}\n")


def utt2spk_to_spk2utt(utt2spk):
    spk2utt = {}
    for utt, spk in utt2spk.items():
        spk2utt.setdefault(spk, []).append(utt)
    return {spk: " ".join(sorted(utts)) for spk, utts in spk2utt.items()}


def spk2utt_to_utt2spk(spk2utt):
    out = {}
    for spk, utts in spk2utt.items():
        for utt in utts.split():
            out[utt] = spk
    return out


def filter_scp(keys, table):
    """Keep table entries whose key is in ``keys`` (utils/filter_scp.pl)."""
    keys = set(keys)
    return {k: v for k, v in table.items() if k in keys}


def apply_map(table, mapping, permissive=False):
    """Map each whitespace token of each value (utils/apply_map.pl /
    sym2int.pl / int2sym.pl backbone)."""
    out = {}
    for key, value in table.items():
        toks = []
        for tok in value.split():
            if tok in mapping:
                toks.append(str(mapping[tok]))
            elif permissive:
                toks.append(tok)
            else:
                raise KeyError(f"token {tok!r} not in map (key {key})")
        out[key] = " ".join(toks)
    return out


def filter_text_by_vocab(table, vocab, oov_word=None):
    """Keep only in-vocabulary words of each transcript, or replace OOVs
    with ``oov_word`` (utils/filt.py role)."""
    vocab = set(vocab)
    out = {}
    for key, text in table.items():
        words = []
        for w in text.split():
            if w in vocab:
                words.append(w)
            elif oov_word is not None:
                words.append(oov_word)
        out[key] = " ".join(words)
    return out


def shuffle_list(items, seed=0):
    items = list(items)
    random.Random(seed).shuffle(items)
    return items


def _present_tables(data_dir, names):
    return [n for n in names if os.path.exists(os.path.join(data_dir, n))]


def validate_data_dir(data_dir, require=("feats.scp", "text")):
    """Check key-set consistency and sortedness; returns list of problems
    (empty = valid).  Role of utils/validate_data_dir.sh."""
    problems = []
    tables = {}
    for name in _present_tables(data_dir, UTT_TABLES):
        path = os.path.join(data_dir, name)
        with open(path, encoding="utf-8") as f:
            keys = [line.split(None, 1)[0] for line in f if line.strip()]
        if keys != sorted(keys):
            problems.append(f"{name}: not sorted")
        if len(keys) != len(set(keys)):
            problems.append(f"{name}: duplicate keys")
        tables[name] = set(keys)
    for name in require:
        if name not in tables:
            problems.append(f"missing required table {name}")
    if tables:
        key_sets = list(tables.values())
        universe = set.union(*key_sets)
        for name, keys in tables.items():
            if keys != universe:
                missing = len(universe - keys)
                problems.append(
                    f"{name}: {missing} utterances missing vs union"
                )
    if os.path.exists(os.path.join(data_dir, "utt2spk")) and os.path.exists(
        os.path.join(data_dir, "spk2utt")
    ):
        u2s = read_table(os.path.join(data_dir, "utt2spk"))
        s2u = read_table(os.path.join(data_dir, "spk2utt"))
        if utt2spk_to_spk2utt(u2s) != {
            k: " ".join(sorted(v.split())) for k, v in s2u.items()
        }:
            problems.append("utt2spk/spk2utt inconsistent")
    return problems


def fix_data_dir(data_dir):
    """Restore consistency: intersect keys across tables, sort, rebuild
    spk2utt (utils/fix_data_dir.sh).  Returns number of utterances kept."""
    names = _present_tables(data_dir, UTT_TABLES)
    tables = {n: read_table(os.path.join(data_dir, n)) for n in names}
    if not tables:
        return 0
    common = set.intersection(*[set(t) for t in tables.values()])
    for name, table in tables.items():
        write_table(os.path.join(data_dir, name),
                    {k: table[k] for k in common})
    if "utt2spk" in tables:
        u2s = {k: tables["utt2spk"][k] for k in common}
        write_table(os.path.join(data_dir, "spk2utt"),
                    utt2spk_to_spk2utt(u2s))
    info("fix_data_dir: kept %d utterances in %s", len(common), data_dir)
    return len(common)


def copy_data_dir(src, dst):
    """utils/copy_data_dir.sh: copy the table files of a data dir."""
    os.makedirs(dst, exist_ok=True)
    for name in _present_tables(src, UTT_TABLES + SPK_TABLES):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    return dst


def subset_data_dir(src, dst, *, n=None, keys=None, first=False, seed=0):
    """utils/subset_data_dir.sh: keep n utterances (random unless first=True)
    or an explicit key list."""
    feats = read_table(os.path.join(src, "feats.scp")) if os.path.exists(
        os.path.join(src, "feats.scp")
    ) else read_table(os.path.join(src, "text"))
    all_keys = sorted(feats)
    if keys is None:
        if first:
            keys = all_keys[:n]
        else:
            keys = sorted(shuffle_list(all_keys, seed)[:n])
    keys = set(keys)
    copy_data_dir(src, dst)
    for name in _present_tables(dst, UTT_TABLES):
        path = os.path.join(dst, name)
        write_table(path, filter_scp(keys, read_table(path)))
    fix_data_dir(dst)
    return dst


def filter_scps(key_lists, table):
    """Batch filter_scp over N key sets in one pass (the
    utils/filter_scps.pl JOB=1:N role): returns a list of filtered
    sub-tables, one per key set."""
    sets = [set(keys) for keys in key_lists]
    return [{k: v for k, v in table.items() if k in s} for s in sets]


def split_scp_per_speaker(keys, utt2spk, num_splits):
    """Split utterance keys into num_splits chunks that COINCIDE WITH
    SPEAKER BOUNDARIES, balancing utterance counts (the
    utils/split_scp.pl --utt2spk contract, reference
    kaldi/utils/split_scp.pl:84-174): speakers are blocked contiguously
    in order of first appearance, allocated ~evenly, then boundary
    speakers are reassigned to the neighbor chunk while that reduces the
    absolute count difference (monotone, so it terminates).  Raises if
    there are fewer speakers than splits."""
    spk_order, spk_utts = [], {}
    for u in keys:
        s = utt2spk[u]
        if s not in spk_utts:
            spk_order.append(s)
            spk_utts[s] = []
        spk_utts[s].append(u)
    if len(spk_order) < num_splits:
        raise ValueError(
            f"refusing to split: {len(spk_order)} speakers < "
            f"{num_splits} splits (utils/split_scp.pl semantics)")
    assign = [[] for _ in range(num_splits)]
    counts = [0] * num_splits
    for i, s in enumerate(spk_order):
        j = i * num_splits // len(spk_order)
        assign[j].append(s)
        counts[j] += len(spk_utts[s])
    changed = True
    while changed:
        changed = False
        for j in range(num_splits):
            if j < num_splits - 1 and assign[j]:
                s = assign[j][-1]
                c = len(spk_utts[s])
                if abs((counts[j + 1] + c) - (counts[j] - c)) < abs(
                        counts[j + 1] - counts[j]):
                    assign[j].pop()
                    assign[j + 1].insert(0, s)
                    counts[j] -= c
                    counts[j + 1] += c
                    changed = True
            if j > 0 and assign[j]:
                s = assign[j][0]
                c = len(spk_utts[s])
                if abs((counts[j] - c) - (counts[j - 1] + c)) < abs(
                        counts[j] - counts[j - 1]):
                    assign[j].pop(0)
                    assign[j - 1].append(s)
                    counts[j] -= c
                    counts[j - 1] += c
                    changed = True
    return [[u for s in chunk for u in spk_utts[s]] for chunk in assign]


def split_data_dir(src, num_splits, out_base=None, *, per_utt=False):
    """utils/split_data.sh: split into N key-disjoint shards
    ``<src>/split<N>/<i>``.  Default splits PER SPEAKER (each speaker's
    utterances land in exactly one shard, balanced by utterance count —
    reference kaldi/utils/split_data.sh:18-21 + split_scp.pl --utt2spk);
    ``per_utt=True`` (the --per-utt flag) ignores speakers and shards
    contiguously in sorted-key order."""
    out_base = out_base or os.path.join(src, f"split{num_splits}")
    feats = read_table(os.path.join(src, "feats.scp"))
    keys = sorted(feats)
    utt2spk_path = os.path.join(src, "utt2spk")
    if not per_utt and os.path.exists(utt2spk_path):
        shards = split_scp_per_speaker(keys, read_table(utt2spk_path),
                                       num_splits)
    else:
        # contiguous split (like split_scp.pl's default), not strided:
        shards = []
        per = len(keys) // num_splits
        extra = len(keys) % num_splits
        start = 0
        for i in range(num_splits):
            size = per + (1 if i < extra else 0)
            shards.append(keys[start : start + size])
            start += size
    dirs = []
    for i, shard in enumerate(shards, start=1):
        d = os.path.join(out_base, str(i))
        subset_data_dir(src, d, keys=shard)
        dirs.append(d)
    return dirs


def combine_data_dirs(dsts, out):
    """utils/combine_data.sh: union of several data dirs (keys must not
    collide)."""
    os.makedirs(out, exist_ok=True)
    names = set()
    for d in dsts:
        names.update(_present_tables(d, UTT_TABLES))
    for name in names:
        merged = {}
        for d in dsts:
            path = os.path.join(d, name)
            if os.path.exists(path):
                table = read_table(path)
                dup = set(merged) & set(table)
                if dup:
                    raise ValueError(
                        f"duplicate keys combining {name}: {sorted(dup)[:5]}"
                    )
                merged.update(table)
        write_table(os.path.join(out, name), merged)
    if os.path.exists(os.path.join(out, "utt2spk")):
        write_table(
            os.path.join(out, "spk2utt"),
            utt2spk_to_spk2utt(read_table(os.path.join(out, "utt2spk"))),
        )
    fix_data_dir(out)
    return out


def subset_data_dir_tr_cv(src, tr_dst, cv_dst, *, cv_spk_fraction=0.1,
                          seed=0):
    """utils/subset_data_dir_tr_cv.sh: speaker-disjoint train/cv split."""
    u2s = read_table(os.path.join(src, "utt2spk"))
    speakers = sorted(set(u2s.values()))
    shuffled = shuffle_list(speakers, seed)
    n_cv = max(1, int(len(speakers) * cv_spk_fraction))
    cv_spk = set(shuffled[:n_cv])
    cv_keys = [u for u, s in u2s.items() if s in cv_spk]
    tr_keys = [u for u, s in u2s.items() if s not in cv_spk]
    subset_data_dir(src, tr_dst, keys=tr_keys)
    subset_data_dir(src, cv_dst, keys=cv_keys)
    return tr_dst, cv_dst
