"""Print the ratios that tests/test_torch_bf16_stream.py gates, for five
seeds: the port's conformer with a bfloat16 stream against the JAX
package's, as the mean (and largest) absolute difference over that between
JAX in bfloat16 and JAX in float32, for the encoder output and the logits;
against JAX compiled with every written bfloat16 rounding kept
(``xla_allow_excess_precision`` off, the tests' reference) and with XLA's
default, and the two JAX compiles against each other; then the first train
step's gradients and the parameters after three steps.  Last, the noise
under chip_smoke.py's BF16_MEDIAN_RATIO and BF16_LEAF_RATIO: the port's own
bfloat16 step on the CPU (tests/test_torch_cuda.py's conformer,
dropout on) against the same step with every weight moved by one float32
ulp, as the same ratios to the stream's own error, beside that
perturbation's effect on the float32 step.

    JAX_PLATFORMS=cpu python -m tests.bf16_stream_ratios
"""

import jax
import numpy as np
import torch

from pytorch_kaldi_asr_tpu.models.encoders import conformer_encode as jenc
from pytorch_kaldi_asr_tpu.models.transformer import transformer_forward
from pytorch_kaldi_asr_tpu_torch.models import transformer as pt
from pytorch_kaldi_asr_tpu_torch.models.encoders import conformer_encode
from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
from tests import test_torch_bf16_stream as T
from tests.torch_port_helpers import jax_params, leaves, source_batch, t


def _both(port, j16, j32):
    """(mean ratio, largest-entry ratio)."""
    port, j16, j32 = T._f32(port), T._f32(j16), T._f32(j32)
    return (float(np.abs(port - j16).mean() / np.abs(j16 - j32).mean()),
            float(np.abs(port - j16).max() / np.abs(j16 - j32).max()))


def main():
    torch.set_num_threads(1)
    j32, j16, _, p16 = T._configs()
    for seed in range(5):
        jparams, params = jax_params(j32, seed=seed)
        src, mask = source_batch(j32, s=20, seed=seed, short_row=13)
        rng = np.random.default_rng(seed)
        tgt = rng.integers(1, j32.vocab_size, size=(3, 7)).astype(np.int32)
        tgt_mask = np.ones((3, 7), np.uint8)
        tgt_mask[1, 4:] = 0
        row = {}
        for name, jfn, port in (
                ("encoder", lambda p, c: jenc(p["encoder"], c, src, mask)[0],
                 conformer_encode(params["encoder"], p16, t(src),
                                  t(mask))[0]),
                ("logits", lambda p, c: transformer_forward(
                    p, c, src, mask, tgt, tgt_mask),
                 pt.transformer_forward(params, p16, t(src), t(mask),
                                        t(tgt), t(tgt_mask)))):
            exact = T._exact(lambda p: jfn(p, j16), jparams)
            default = jax.jit(lambda p: jfn(p, j16))(jparams)
            f32 = jax.jit(lambda p: jfn(p, j32))(jparams)
            row[name] = {"port_vs_exact": _both(port, exact, f32),
                         "port_vs_default": _both(port, default, f32),
                         "default_vs_exact": _both(default, exact, f32)}
        print(f"seed {seed} (mean, largest): {row}")

    jparams, params = jax_params(j32, seed=3)
    batch = T._batch(j32)
    g16 = T._jax_grads(jparams, j16, batch, True)
    g32 = T._jax_grads(jparams, j32, batch, False)
    state = create_train_state(params, start_lr=0.01, soft_coefficient=2.0)
    train_step(state, p16, *(t(x) for x in batch))
    ratios = T._leaf_ratios([p.grad for p in leaves(state.params)], g16, g32)
    print(f"first step's gradients: {len(ratios)} leaves, median "
          f"{np.median(ratios):.3g}, largest {max(ratios):.3g}")
    three_steps(jparams, batch)
    one_ulp_control()


def three_steps(jparams, batch):
    """The parameters after three Adam steps, as the test takes them."""
    import jax.numpy as jnp

    from pytorch_kaldi_asr_tpu.train import (
        create_train_state as jax_state,
        make_train_step,
    )
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax

    j32, j16, _, p16 = T._configs()
    jbatch = tuple(jnp.asarray(x) for x in batch)
    final = {}
    for name, cfg in (("bf16", j16), ("f32", j32)):
        jstate, tx = jax_state(jparams, start_lr=0.01, soft_coefficient=2.0)
        step = make_train_step(cfg, tx, donate=False)
        if name == "bf16":
            step = step.lower(jstate, *jbatch).compile(
                compiler_options=T.EXACT)
        for _ in range(3):
            jstate, _ = step(jstate, *jbatch)
        final[name] = jstate.params
    state = create_train_state(params_from_jax(jax.device_get(jparams)),
                               start_lr=0.01, soft_coefficient=2.0)
    for _ in range(3):
        train_step(state, p16, *(t(x) for x in batch))
    ratios = T._leaf_ratios(leaves(state.params), final["bf16"],
                            final["f32"])
    print(f"parameters after three steps: {len(ratios)} leaves, median "
          f"{np.median(ratios):.3g}, largest {max(ratios):.3g}")


def one_ulp_control():
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
        tree_map,
    )
    from pytorch_kaldi_asr_tpu_torch.train.optim import trainable_leaves

    cfg = TransformerConfig(
        src_dim=40, vocab_size=52, encoder_max_len=128, decoder_max_len=20,
        encoder_sub_sequence=(-32, 32), decoder_sub_sequence=(-10, 0),
        en_layers=2, de_layers=2, n_head=2, en_d_model=64, de_d_model=32,
        d_k=16, d_v=16, en_dropout=0.1, de_dropout=0.1,
        encoder_type="conformer", conformer_stream_dtype="bfloat16")
    cfg32 = cfg.replace(conformer_stream_dtype="float32")
    params = init_transformer(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(3)
    src = torch.randn((3, 120, 40), generator=g)
    mask = torch.ones((3, 120), dtype=torch.uint8)
    mask[2, 70:] = 0
    tgt = torch.tensor([[2, 5, 9, 3, 0], [2, 7, 3, 0, 0], [2, 4, 4, 6, 3]])
    batch = (src, mask, tgt, (tgt != 0).to(torch.uint8))
    signs = torch.Generator().manual_seed(9)

    def one_ulp(x):
        s = torch.randint(0, 2, x.shape, generator=signs).float() * 2 - 1
        return x * (1 + s * 2.0 ** -23)

    def step(p, c):
        state = create_train_state(tree_map(lambda x: x.detach().clone(), p))
        loss = float(train_step(state, c, *batch)["loss"])
        return loss, [q.grad for q in trainable_leaves(state.params)]

    moved = tree_map(one_ulp, params)
    for name, c, other in (("bfloat16", cfg, cfg32), ("float32", cfg32, cfg)):
        (l0, g0), (l1, g1), (lo, go) = (step(params, c), step(moved, c),
                                        step(params, other))
        largest = [float((a - b).abs().max()) / float((b - o).abs().max())
                   for a, b, o in zip(g1, g0, go)]
        mean = [float((a - b).abs().mean()) / float((b - o).abs().mean())
                for a, b, o in zip(g1, g0, go)]
        print(f"{name} step, weights one float32 ulp off, over the stream's "
              f"own error: loss {abs(l1 - l0) / abs(l0 - lo):.3g}; "
              f"gradients largest-entry median {np.median(largest):.3g}, "
              f"largest {max(largest):.3g}; mean median "
              f"{np.median(mean):.3g}, largest {max(mean):.3g}")


if __name__ == "__main__":
    main()
