"""Run torch-0.4-era code (the reference implementation) under torch 2.x:
the port's copy of the JAX package's ``tools/torch04_compat.py``.

The reference targets PyTorch 0.4.1.  Four API drifts break it on a modern
install; ``install()`` patches them process-wide without touching the
reference's code:

- ``Tensor.view`` on non-contiguous tensors now raises (the reference
  reshapes attention outputs that are permuted views); fall back to
  ``reshape``;
- ``masked_fill(_)`` requires bool masks, the reference passes uint8;
- ``nn.init.xavier_normal``/``xavier_uniform`` lost their non-underscore
  aliases;
- ``torch.load`` defaults to ``weights_only=True`` and the reference
  checkpoints pickle the entire module object.

``install()`` changes ``torch`` for the whole process, so nothing on the
port's paths imports this module: it is for a process that runs the
reference's own code (a golden recording, a parity run).  A second call
does nothing.
"""

from __future__ import annotations


def install():
    import torch

    if getattr(torch, "_pka_torch04_compat", False):
        return
    torch._pka_torch04_compat = True

    orig_view = torch.Tensor.view

    def _view(self, *shape):
        try:
            return orig_view(self, *shape)
        except RuntimeError:
            return self.reshape(*shape)

    torch.Tensor.view = _view

    for name in ("masked_fill_", "masked_fill"):
        orig = getattr(torch.Tensor, name)

        def _mf(self, mask, value, _orig=orig):
            if mask.dtype == torch.uint8:
                mask = mask.bool()
            return _orig(self, mask, value)

        setattr(torch.Tensor, name, _mf)

    if not hasattr(torch.nn.init, "xavier_normal"):
        torch.nn.init.xavier_normal = torch.nn.init.xavier_normal_
    if not hasattr(torch.nn.init, "xavier_uniform"):
        torch.nn.init.xavier_uniform = torch.nn.init.xavier_uniform_

    orig_load = torch.load

    def _load(*args, **kw):
        kw.setdefault("weights_only", False)
        return orig_load(*args, **kw)

    torch.load = _load
