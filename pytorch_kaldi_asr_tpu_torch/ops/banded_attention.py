"""Banded (time-restricted) attention: hand-written CUDA kernels for Hopper
beside their plain PyTorch versions.

Position t attends keys ``[t+start, t+end]`` (``start <= 0 <= end``) that
are also marked valid; scores are scaled by the caller's ``scale`` (the
model uses 1/sqrt(d_model)); a query row with no valid key in its band
outputs exact zeros.  Layout: q, k ``[BH, S, D]``, v ``[BH, S, Dv]``,
key_valid ``[BH, S]``, out ``[BH, S, Dv]``.

:func:`banded_attention` is the inference path.  It pads S up to the
kernel's tile (padded keys invalid), then sends a CPU tensor to
:func:`banded_attention_reference` and a CUDA tensor to the kernel K1
(``banded_attention_kernel`` in ``csrc/banded_attention_train.cu``, K2a's
routine without lse and dropout), and slices the padding off.  There is no
length threshold and no fall back: a CUDA tensor the kernel cannot take
raises.  ``banded_attention.launches`` counts kernel launches.

:func:`banded_attention_trainable` is the training path: the same function
plus attention-probability dropout, differentiable through one
``torch.autograd.Function`` whose forward runs :func:`banded_attention_fwd`
(K2a) and whose backward runs :func:`banded_attention_dq` (K2b, which
also computes delta = rowsum(dout * out)) and :func:`banded_attention_dkv`
(K2c), the kernels of ``csrc/banded_attention_train.cu`` (on bfloat16,
K2b and K2c of ``csrc/banded_attention_bwd_sm90.cu``, written for Hopper's
wgmma, TMA and mbarriers).  Each of the three sends a CUDA tensor to its
kernel and a CPU tensor to its banded plain version, and counts its kernel
launches in ``.launches``.

K2a-c have two plain versions each.  The full ones
(``banded_attention_*_reference``) build the [BH, S, S] scores; they are
the yardstick the kernels are held against.  The banded ones
(``*_blocked``, the JAX package's ``banded_attention_blocked`` blocking)
score each 64-query block against only the key blocks its band reaches,
with the same dropout hash and the same bfloat16 roundings; they are what
a CPU tensor trains through, and they agree with the full ones within
float32's summation order (tests/test_torch_banded_plain.py).  K1's CPU
path keeps the full version: the card-against-CPU n-best gate (1e-4 on a
score near -736, two float32 ulps) read 1.22e-4 with the conformer's CPU
decode summed in the banded order (PERF.md §6).  The dropout
mask is :func:`dropout_keep`, the JAX package's hash, bit for bit, so a
run is reproducible across the two packages and the kernels regenerate the
forward's mask in the backward.

Every function takes float32 or bfloat16 q, k, v (and dout, out), all of
one dtype; lse and delta are float32.  On bfloat16 the kernels and the
plain versions compute the JAX package's Pallas kernels' function on
bfloat16 inputs: scores, softmax statistics and sums in float32, the
second product's operand (the dropped probabilities, dS) rounded to
bfloat16 where the Pallas kernels round it, the outputs rounded once to
bfloat16.  A bfloat16 CUDA tensor runs the kernels' bfloat16
instantiations (``launches_bf16`` counts them), never the float32 ones.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.models.common import masked_softmax

BLOCK = 64  # query and key tile of the kernel (BLOCK_Q = BLOCK_K in the .cu)
MAX_HEAD_DIM = 128  # largest d and dv the kernel takes


def banded_attention_reference(q, k, v, key_valid, start, end, scale):
    """Plain PyTorch version: full [BH, S, S] scores + band/validity mask.
    On bfloat16, the Pallas kernel's function: K2a's plain version at rate 0
    (the unnormalised probabilities rounded to bfloat16 before p.v)."""
    if q.dtype == torch.bfloat16:
        return banded_attention_trainable_reference(q, k, v, key_valid, 0,
                                                    start, end, scale)[0]
    s = q.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    pos = torch.arange(s, device=q.device)
    rel = pos[None, :] - pos[:, None]
    band = (rel >= start) & (rel <= end)
    mask = band[None, :, :] & (key_valid[:, None, :] > 0)
    p = masked_softmax(logits, ~mask)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _pad_seq(x, s_pad):
    return F.pad(x, (0, 0, 0, s_pad - x.shape[1])) if s_pad > x.shape[1] else x


def _check_and_pad(q, k, v, key_valid, start, end):
    """Validate the band and shapes; pad S to a multiple of ``BLOCK`` (zero
    rows, invalid keys).  Returns the padded (q, k, v, key_valid int32)."""
    if not start <= 0 <= end:
        raise ValueError("band must satisfy start <= 0 <= end")
    bh, s, d = q.shape
    if k.shape != (bh, s, d) or v.shape[:2] != (bh, s) \
            or key_valid.shape != (bh, s):
        raise ValueError("q/k [BH,S,D], v [BH,S,Dv] and key_valid [BH,S] "
                         "must agree")
    s_pad = -(-s // BLOCK) * BLOCK
    q, k, v = (_pad_seq(x, s_pad) for x in (q, k, v))
    key_valid = key_valid.to(torch.int32)
    if s_pad > s:
        key_valid = F.pad(key_valid, (0, s_pad - s))
    return q, k, v, key_valid


def banded_attention(q, k, v, key_valid, *, start, end, scale):
    """Banded attention; CUDA tensors run the Hopper kernel, CPU tensors the
    plain version.  Any S: the sequence is padded to a multiple of
    ``BLOCK`` with invalid keys, and the padded rows are dropped."""
    s = q.shape[1]
    q, k, v, key_valid = _check_and_pad(q, k, v, key_valid, start, end)
    if q.is_cuda:
        out = _launch(q, k, v, key_valid, start, end, scale)
    elif q.device.type == "cpu":
        out = banded_attention_reference(q, k, v, key_valid, start, end,
                                         scale)
    else:
        raise ValueError(f"banded_attention: unsupported device {q.device}")
    return out[:, :s]


banded_attention.launches = 0
banded_attention.launches_bf16 = 0


def _kernel_operands(name, vectors, rows=(), ints=()):
    """Checks shared by every kernel wrapper: one device; ``vectors`` (q, k,
    v, dout, out) all float32 or all bfloat16, with head dims the kernels
    take (multiples of 4, or of 8 on bfloat16: 16 bytes a load); ``rows``
    (lse, delta) float32.  Then contiguous copies, 16-byte aligned (the
    kernels read rows 16 bytes at a time, the bfloat16 backward's copy
    engine 16-byte aligned blocks).  Returns (vectors, rows, ints)."""
    tensors = (*vectors, *rows, *ints)
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    dtype = vectors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dtype for t in vectors):
        raise TypeError(f"{name} kernel takes q, k, v (and dout, out) all "
                        f"float32 or all bfloat16, got "
                        f"{[t.dtype for t in vectors]}")
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{name} kernel takes float32 lse and delta")
    step = 4 if dtype == torch.float32 else 8
    dims = {t.shape[-1] for t in vectors}
    if any(x % step or x > MAX_HEAD_DIM for x in dims):
        raise ValueError(f"{name} kernel needs d, dv multiples of {step} and "
                         f"<= {MAX_HEAD_DIM} on {dtype}, got {sorted(dims)}")
    aligned = [t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (x.contiguous() for x in (*vectors, *rows, *ints))]
    n_vec, n_rows = len(vectors), len(vectors) + len(rows)
    return aligned[:n_vec], aligned[n_vec:n_rows], aligned[n_rows:]


def _count(wrapper, dtype):
    """One more launch of ``wrapper``'s kernel on ``dtype``."""
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1



def _run(name, fn, device, *args):
    """Call C entry point ``fn`` on PyTorch's current stream of ``device``;
    raise if the launch was refused.  Under torch.profiler the call is a
    ``name`` range, so a trace attributes the kernel to its wrapper
    (tools/trace_summary.summarize_by_source); otherwise nothing is
    recorded."""
    annotate = (torch.profiler.record_function(name)
                if torch.autograd._profiler_enabled()
                else contextlib.nullcontext())
    with torch.cuda.device(device), annotate:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch(q, k, v, key_valid, start, end, scale):
    """Run the CUDA kernel on PyTorch's current stream; S % BLOCK == 0."""
    (q, k, v), _, (key_valid,) = _kernel_operands(
        "banded_attention", (q, k, v), ints=(key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    _run("banded_attention", _kernel_fn("k1", q.dtype), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
         out.data_ptr(), bh, s, d, dv, int(start), int(end), float(scale))
    _count(banded_attention, q.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fn(which, dtype=torch.float32):
    """:func:`kernel_entry` ``which`` on ``dtype``, built at first use: the
    bfloat16 K2b and K2c from csrc/banded_attention_bwd_sm90.cu, every other
    kernel from csrc/banded_attention_train.cu (the unit of ``dtype``:
    ops/_build.py compiles one per element type)."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    if dtype == torch.bfloat16 and which in ("dq", "dkv"):
        library = _build.load("banded_attention_bwd_sm90")
    else:
        library = _build.load("banded_attention_train",
                              "bf16" if dtype == torch.bfloat16 else "f32")
    return kernel_entry(library, which, dtype)


def kernel_entry(library, which, dtype=torch.float32):
    """The C entry point of K1 (``which`` "k1": ``banded_attention_f32``)
    or of K2a/K2b/K2c ("fwd", "dq", "dkv": ``banded_attention_{which}_f32``)
    on float32, or its ``_bf16`` twin on bfloat16, of a ``ctypes.CDLL``
    built from csrc/banded_attention_train.cu or, for the bfloat16 K2b and
    K2c, csrc/banded_attention_bwd_sm90.cu (or a version of either),
    signature set: pointers, then (bh, s, d, dv, start, end) ints, scale,
    then for K2 the dropout (seed, threshold as uint32, keep probability,
    on), and the stream."""
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    if which == "k1":
        fn = getattr(library, f"banded_attention_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        n_ptr = {"fwd": 6, "dq": 9, "dkv": 9}[which]
        fn = getattr(library, f"banded_attention_{which}_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# trainable path: K2a/K2b/K2c and their plain versions
# ---------------------------------------------------------------------------

MAX_SEED = 2**31 - 2  # seeds are int32 draws from [0, 2**31 - 1)
_M32 = 0xFFFFFFFF


def dropout_threshold(rate):
    """The hash threshold of ``rate``: a 32-bit hash at or above it keeps
    the entry.  Computed in Python double, as the JAX package does."""
    return int(rate * 0xFFFFFFFF)


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and ``c`` < 2**32:
    one int64 multiply, which wraps past 2**63 but keeps the product's low
    64 bits, so its low 32 are exact."""
    return (x * c).bitwise_and_(_M32)


def dropout_keep(seed, bh, q_pos, k_pos, rate):
    """Keep mask of the attention-probability dropout: the JAX package's
    ``_dropout_keep`` (a lowbias32-style uint32 hash of the seed, the
    b-major batch-head index and the GLOBAL query/key positions) bit for
    bit, in int64 arithmetic masked to 32 bits.  ``bh``, ``q_pos`` and
    ``k_pos`` are ints or int64 tensors that broadcast."""
    x = (_mul32(torch.as_tensor(q_pos, dtype=torch.int64), 2654435761)
         + _mul32(torch.as_tensor(k_pos, dtype=torch.int64), 2246822519)
         + _mul32(torch.as_tensor(bh, dtype=torch.int64), 3266489917)
         + int(seed)).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x.bitwise_xor_(x >> 15)
    x = _mul32(x, 0x846CA68B)
    x.bitwise_xor_(x >> 16)
    return x >= dropout_threshold(rate)


def _keep_mask(seed, bh, s, rate, device):
    """The [BH, S, S] keep mask, or None when ``rate`` is 0."""
    if rate <= 0.0:
        return None
    pos = torch.arange(s, device=device)
    rows = torch.arange(bh, device=device)[:, None, None]
    return dropout_keep(seed, rows, pos[None, :, None], pos[None, None, :],
                        rate)


def _allowed(s, start, end, key_valid):
    """[BH, S, S]: key in the query's band and valid."""
    pos = torch.arange(s, device=key_valid.device)
    rel = pos[None, :] - pos[:, None]
    band = (rel >= start) & (rel <= end)
    return band[None] & (key_valid[:, None, :] > 0)


def _drop(x, keep, rate):
    """x where kept, scaled by 1/(1 - rate), as the Pallas kernels write it."""
    return x if keep is None else torch.where(keep, x, 0.0) / (1.0 - rate)


def _up(x):
    """A bfloat16 ``x`` in float32 (exact); any other ``x`` as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _rounded(x, dtype):
    """x rounded to ``dtype`` and back to float32 (the Pallas kernels'
    ``.astype(v.dtype)`` before a product); x itself on float32."""
    return x if dtype != torch.bfloat16 else x.to(dtype).float()


def banded_attention_trainable_reference(q, k, v, key_valid, seed, start,
                                         end, scale, dropout_rate=0.0):
    """Plain, autograd-differentiable version of K2a: returns (out, lse).

    ``out = drop(p) @ v / l`` with ``p = exp(s - m)`` over the band's valid
    keys and ``l`` the sum of the UNdropped p, so the dropout acts on the
    normalised probabilities; ``lse = m + log(l)``, -inf for a row with no
    key (whose output is exact zeros).

    On bfloat16: q, k, v in float32 (a product of two bfloat16 is exact
    there), the dropped p rounded to bfloat16 before p @ v, out rounded to
    bfloat16."""
    dtype = q.dtype
    q, k, v = _up(q), _up(k), _up(v)
    bh, s, _ = q.shape
    allowed = _allowed(s, start, end, key_valid)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    logits = logits.masked_fill(~allowed, float("-inf"))
    # softmax is shift-invariant: the max carries no gradient
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = _rounded(_drop(p, _keep_mask(seed, bh, s, dropout_rate, q.device),
                       dropout_rate), dtype)
    out = torch.einsum("bqk,bkd->bqd", p, v) / torch.where(
        l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      float("-inf"))
    return out.to(dtype), lse[..., 0].detach()


def _probs(q, k, key_valid, lse, start, end, scale):
    """a = exp(s - lse) over the band's valid keys, 0 elsewhere and on rows
    with lse = -inf."""
    live = torch.isfinite(lse)[..., None]
    lse_safe = torch.where(live, lse[..., None], 0.0)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    mask = _allowed(q.shape[1], start, end, key_valid) & live
    return torch.where(mask, torch.exp(logits - lse_safe), 0.0)


def banded_attention_dq_reference(q, k, v, key_valid, dout, out, lse, seed,
                                  start, end, scale, dropout_rate=0.0):
    """Plain version of K2b: (dq, delta) with delta = rowsum(dout * out) and
    dq = scale * (a * (drop(dout v^T) - delta)) k.  On bfloat16, computed
    in float32 with dS rounded to bfloat16 before dS k, dq rounded."""
    dtype = q.dtype
    q, k, v, dout, out = (_up(x) for x in (q, k, v, dout, out))
    delta = (dout * out).sum(dim=-1)
    a = _probs(q, k, key_valid, lse, start, end, scale)
    keep = _keep_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device)
    dp = _drop(torch.einsum("bqd,bkd->bqk", dout, v), keep, dropout_rate)
    ds = _rounded(a * (dp - delta[..., None]), dtype)
    return (torch.einsum("bqk,bkd->bqd", ds, k) * scale).to(dtype), delta


def banded_attention_dkv_reference(q, k, v, key_valid, dout, lse, delta,
                                   seed, start, end, scale, dropout_rate=0.0):
    """Plain version of K2c: (dk, dv) with dv = drop(a)^T dout and
    dk = scale * (a * (drop(dout v^T) - delta))^T q.  On bfloat16, computed
    in float32 with drop(a) and dS rounded to bfloat16 before their
    products, dk and dv rounded."""
    dtype = q.dtype
    q, k, v, dout = (_up(x) for x in (q, k, v, dout))
    a = _probs(q, k, key_valid, lse, start, end, scale)
    keep = _keep_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device)
    dv = torch.einsum("bqk,bqd->bkd",
                      _rounded(_drop(a, keep, dropout_rate), dtype), dout)
    dp = _drop(torch.einsum("bqd,bkd->bqk", dout, v), keep, dropout_rate)
    ds = _rounded(a * (dp - delta[..., None]), dtype)
    return ((torch.einsum("bqk,bqd->bkd", ds, q) * scale).to(dtype),
            dv.to(dtype))


# ---------------------------------------------------------------------------
# banded plain versions: scores only for the key blocks of each query block's
# band (the JAX package's ``banded_attention_blocked``), the CPU's path
# ---------------------------------------------------------------------------

PLAIN_BLOCK = 64  # query block of the banded plain versions


class _Windows:
    """The blocking of the banded plain versions: S padded to a multiple of
    ``PLAIN_BLOCK``, cut into ``nb`` query blocks, each against the window
    of ``w`` keys that covers its band (the blocks from ``n_back`` before
    it to ``n_fwd`` after).  Positions stay global, so the dropout hash and
    the band test read what the full versions read; keys outside [0, S)
    are invalid."""

    def __init__(self, key_valid, start, end):
        bh, s = key_valid.shape
        self.s, self.bq = s, PLAIN_BLOCK
        self.s_pad = -(-s // self.bq) * self.bq
        self.nb = self.s_pad // self.bq
        self.n_back = min(-(start // self.bq), self.nb - 1)
        self.n_fwd = min(-(-end // self.bq), self.nb - 1)
        self.w = (self.n_back + 1 + self.n_fwd) * self.bq
        device = key_valid.device
        q_pos = (torch.arange(self.nb, device=device)[:, None] * self.bq
                 + torch.arange(self.bq, device=device))
        k_pos = (torch.arange(self.nb, device=device)[:, None] * self.bq
                 - self.n_back * self.bq + torch.arange(self.w, device=device))
        self.q_pos, self.k_pos = q_pos[:, :, None], k_pos[:, None, :]
        rel = self.k_pos - self.q_pos
        valid = self.window(self.pad(key_valid.to(torch.int32)))
        # [BH, nb, bq, w]: key in the query's band and valid
        self.allowed = (((rel >= start) & (rel <= end))[None]
                        & (valid[:, :, None, :] > 0))

    def pad(self, x, value=0.0):
        """x [BH, S, ...] padded to S_pad rows of ``value``."""
        extra = self.s_pad - x.shape[1]
        if not extra:
            return x
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, extra), value=value)

    def blocks(self, x):
        """Query rows [BH, S_pad, ...] → [BH, nb, bq, ...]."""
        return x.reshape(x.shape[0], self.nb, self.bq, *x.shape[2:])

    def window(self, x):
        """Key rows [BH, S_pad, ...] → [BH, nb, w, ...], zeros outside."""
        lo, hi = self.n_back * self.bq, self.n_fwd * self.bq
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (lo, hi))
        win = x.unfold(1, self.w, self.bq)  # window axis last
        return win if win.dim() == 3 else win.movedim(-1, 2)

    def fold(self, xw):
        """[BH, nb, w, D] summed back onto the key rows: [BH, S, D]."""
        bh, _, _, d = xw.shape
        n_off = self.n_back + 1 + self.n_fwd
        out = xw.new_zeros((bh, self.nb + n_off - 1, self.bq, d))
        parts = xw.reshape(bh, self.nb, n_off, self.bq, d)
        for o in range(n_off):
            out[:, o:o + self.nb] += parts[:, :, o]
        lo = self.n_back * self.bq
        return out.reshape(bh, -1, d)[:, lo:lo + self.s]

    def keep(self, seed, rate):
        """The [BH, nb, bq, w] keep mask of :func:`dropout_keep`, or None
        when ``rate`` is 0."""
        if rate <= 0.0:
            return None
        bh = self.allowed.shape[0]
        rows = torch.arange(bh, device=self.q_pos.device)[:, None, None, None]
        return dropout_keep(seed, rows, self.q_pos[None],
                            self.k_pos.clamp_min(0)[None], rate)

    def rows(self, x):
        """Blocked rows [BH, nb, bq, ...] → [BH, S, ...]."""
        return x.reshape(x.shape[0], self.s_pad, *x.shape[3:])[:, :self.s]


def banded_attention_trainable_blocked(q, k, v, key_valid, seed, start, end,
                                       scale, dropout_rate=0.0):
    """:func:`banded_attention_trainable_reference`'s (out, lse) over the
    band windows (not differentiable: the CPU's K2a).  The same dropout
    hash per (bh, q_pos, k_pos) and, on bfloat16, the same roundings."""
    dtype = q.dtype
    q, k, v = _up(q), _up(k), _up(v)
    win = _Windows(key_valid, start, end)
    logits = torch.einsum("bnqd,bnkd->bnqk", win.blocks(win.pad(q)),
                          win.window(win.pad(k))) * scale
    logits = logits.masked_fill(~win.allowed, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = _rounded(_drop(p, win.keep(seed, dropout_rate), dropout_rate), dtype)
    out = torch.einsum("bnqk,bnkd->bnqd", p, win.window(win.pad(v))) \
        / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      float("-inf"))
    return win.rows(out).to(dtype), win.rows(lse[..., 0])


def _blocked_probs(win, q_blk, k_win, lse, scale):
    """:func:`_probs` over the band windows."""
    lse = win.blocks(win.pad(lse[..., None], float("-inf")))
    live = torch.isfinite(lse)
    logits = torch.einsum("bnqd,bnkd->bnqk", q_blk, k_win) * scale
    return torch.where(win.allowed & live,
                       torch.exp(logits - torch.where(live, lse, 0.0)), 0.0)


def banded_attention_dq_blocked(q, k, v, key_valid, dout, out, lse, seed,
                                start, end, scale, dropout_rate=0.0):
    """:func:`banded_attention_dq_reference` over the band windows (the
    CPU's K2b): (dq, delta)."""
    dtype = q.dtype
    q, k, v, dout, out = (_up(x) for x in (q, k, v, dout, out))
    delta = (dout * out).sum(dim=-1)
    win = _Windows(key_valid, start, end)
    k_win = win.window(win.pad(k))
    dout_blk = win.blocks(win.pad(dout))
    a = _blocked_probs(win, win.blocks(win.pad(q)), k_win, lse, scale)
    dp = _drop(torch.einsum("bnqd,bnkd->bnqk", dout_blk,
                            win.window(win.pad(v))),
               win.keep(seed, dropout_rate), dropout_rate)
    ds = _rounded(a * (dp - win.blocks(win.pad(delta[..., None]))), dtype)
    dq = win.rows(torch.einsum("bnqk,bnkd->bnqd", ds, k_win))
    return (dq * scale).to(dtype), delta


def banded_attention_dkv_blocked(q, k, v, key_valid, dout, lse, delta, seed,
                                 start, end, scale, dropout_rate=0.0):
    """:func:`banded_attention_dkv_reference` over the band windows (the
    CPU's K2c): (dk, dv), each key's window terms summed back onto it."""
    dtype = q.dtype
    q, k, v, dout = (_up(x) for x in (q, k, v, dout))
    win = _Windows(key_valid, start, end)
    q_blk, dout_blk = win.blocks(win.pad(q)), win.blocks(win.pad(dout))
    a = _blocked_probs(win, q_blk, win.window(win.pad(k)), lse, scale)
    keep = win.keep(seed, dropout_rate)
    dv = win.fold(torch.einsum(
        "bnqk,bnqd->bnkd", _rounded(_drop(a, keep, dropout_rate), dtype),
        dout_blk))
    dp = _drop(torch.einsum("bnqd,bnkd->bnqk", dout_blk,
                            win.window(win.pad(v))), keep, dropout_rate)
    ds = _rounded(a * (dp - win.blocks(win.pad(delta[..., None]))), dtype)
    dk = win.fold(torch.einsum("bnqk,bnqd->bnkd", ds, q_blk))
    return (dk * scale).to(dtype), dv.to(dtype)


def bf16_ulps(got, want):
    """|got - want| in bfloat16 ulps of each entry's scale: the larger of
    its row's largest |want| and 1/64 of the tensor's largest.  The
    tolerance metric of the bfloat16 kernels against their plain versions:
    an attention output or gradient row sums terms of its row's scale, so
    its rounding errors are of that size however small the entry is (a row
    that cancels to about 0 has errors of the tensor's scale)."""
    got, want = got.double(), want.double()
    scale = torch.maximum(want.abs().amax(-1, keepdim=True),
                          want.abs().max() / 64).clamp_min(1e-30)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


def _dropout_args(seed, rate):
    """(seed, threshold, keep probability, on) as the C entry points take
    them; the threshold in Python double, the keep probability rounded once
    to float32 by ctypes, as the Pallas kernels' 1 - rate is."""
    return (int(seed), dropout_threshold(rate), 1.0 - rate, int(rate > 0.0))


def banded_attention_fwd(q, k, v, key_valid, seed, *, start, end, scale,
                         dropout_rate=0.0):
    """K2a: (out, lse [BH, S]) of the trainable forward; S % BLOCK == 0.
    A CUDA tensor launches the kernel, a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return banded_attention_trainable_blocked(
            q, k, v, key_valid, seed, start, end, scale, dropout_rate)
    (q, k, v), _, (key_valid,) = _kernel_operands(
        "banded_attention_fwd", (q, k, v), ints=(key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _run("banded_attention_fwd", _kernel_fn("fwd", q.dtype), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
         out.data_ptr(), lse.data_ptr(), bh, s, d, dv, int(start), int(end),
         float(scale), *_dropout_args(seed, dropout_rate))
    _count(banded_attention_fwd, q.dtype)
    return out, lse


def banded_attention_dq(q, k, v, key_valid, dout, out, lse, seed, *, start,
                        end, scale, dropout_rate=0.0):
    """K2b: (dq, delta) of the trainable attention, delta = rowsum(dout *
    out) [BH, S] for K2c; S % BLOCK == 0.  A CUDA tensor launches the kernel
    (which computes delta too), a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return banded_attention_dq_blocked(q, k, v, key_valid, dout, out,
                                           lse, seed, start, end, scale,
                                           dropout_rate)
    (q, k, v, dout, out), (lse,), (key_valid,) = _kernel_operands(
        "banded_attention_dq", (q, k, v, dout, out), (lse,), (key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _run("banded_attention_dq", _kernel_fn("dq", q.dtype), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
         out.data_ptr(), lse.data_ptr(), key_valid.data_ptr(), dq.data_ptr(),
         delta.data_ptr(), bh, s, d, dv, int(start), int(end), float(scale),
         *_dropout_args(seed, dropout_rate))
    _count(banded_attention_dq, q.dtype)
    return dq, delta


def banded_attention_dkv(q, k, v, key_valid, dout, lse, delta, seed, *,
                         start, end, scale, dropout_rate=0.0):
    """K2c: (dk, dv) of the trainable attention; S % BLOCK == 0.  A CUDA
    tensor launches the kernel, a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return banded_attention_dkv_blocked(q, k, v, key_valid, dout, lse,
                                            delta, seed, start, end, scale,
                                            dropout_rate)
    (q, k, v, dout), (lse, delta), (key_valid,) = _kernel_operands(
        "banded_attention_dkv", (q, k, v, dout), (lse, delta), (key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    dk = torch.empty_like(k)
    dv_out = torch.empty_like(v)
    _run("banded_attention_dkv", _kernel_fn("dkv", q.dtype), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), key_valid.data_ptr(), dk.data_ptr(),
         dv_out.data_ptr(), bh, s, d, dv, int(start), int(end), float(scale),
         *_dropout_args(seed, dropout_rate))
    _count(banded_attention_dkv, q.dtype)
    return dk, dv_out


for _wrapper in (banded_attention_fwd, banded_attention_dq,
                 banded_attention_dkv):
    _wrapper.launches = 0
    _wrapper.launches_bf16 = 0


class _BandedAttentionTrainable(torch.autograd.Function):
    """K2a forward; K2b then K2c backward.  K2b also computes delta =
    rowsum(dout * out), which K2c reads, so on the card one backward is
    exactly two launches.  S % BLOCK == 0; padded query rows get dout = 0
    from the slice, so their delta and their ds are exactly 0."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, seed, start, end, scale, rate):
        out, lse = banded_attention_fwd(q, k, v, key_valid, seed, start=start,
                                        end=end, scale=scale,
                                        dropout_rate=rate)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        ctx.args = dict(start=start, end=end, scale=scale, dropout_rate=rate)
        ctx.seed = seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        dout = dout.contiguous()  # once for both kernels
        dq, delta = banded_attention_dq(q, k, v, key_valid, dout, out, lse,
                                        ctx.seed, **ctx.args)
        dk, dv = banded_attention_dkv(q, k, v, key_valid, dout, lse, delta,
                                      ctx.seed, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def banded_attention_trainable(q, k, v, key_valid, seed, *, start, end, scale,
                               dropout_rate=0.0):
    """Differentiable banded attention with attention-probability dropout
    (``dropout(softmax(banded(q k^T scale))) @ v``), the JAX package's
    ``banded_attention_trainable``.  ``seed`` is a Python int in
    [0, MAX_SEED]; the mask is :func:`dropout_keep` of it.  Any S: padded
    to a multiple of ``BLOCK`` with invalid keys, the padded rows dropped.
    A CUDA tensor runs the kernels K2a/K2b/K2c, a CPU tensor their plain
    versions, through the same autograd function."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if not 0 <= int(seed) <= MAX_SEED:
        raise ValueError(f"seed must be in [0, {MAX_SEED}], got {seed}")
    s = q.shape[1]
    q, k, v, key_valid = _check_and_pad(q, k, v, key_valid, start, end)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"banded_attention_trainable: unsupported device "
                         f"{q.device}")
    out = _BandedAttentionTrainable.apply(q, k, v, key_valid, int(seed),
                                          int(start), int(end), float(scale),
                                          float(dropout_rate))
    # no slice when nothing was padded: its backward would add two launches
    return out if out.shape[1] == s else out[:, :s]
