"""One rank of the port's parallel tests: a gloo process that imports only
torch and the port.

    python tests/torch_parallel_worker.py SUITE JOB N PORT WORKDIR DEVICE

``JOB`` is 1-based (the launcher's ``JOB=1:N`` array: rank JOB-1 of N);
the ranks meet at 127.0.0.1:PORT.  The suite's cases are read from
``WORKDIR/inputs.pt`` (written by the test module: the JAX package's
weights carried over, the inputs from numpy seeds), and this rank's
results are written to ``WORKDIR/out.<rank>.pt``.  Suites: ``sp``
(parallel/sequence.py), ``dptp`` (the dp x tp step), ``pp``
(parallel/pipeline.py), ``psum`` (multihost.initialize and one psum),
``sp_cuda`` (an SP step with every rank on cuda:0: DEVICE ``cuda``).
"""

import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

from pytorch_kaldi_asr_tpu_torch.models.transformer import (  # noqa: E402
    TransformerConfig,
)
from pytorch_kaldi_asr_tpu_torch.parallel import collectives  # noqa: E402
from pytorch_kaldi_asr_tpu_torch.parallel import multihost  # noqa: E402
from pytorch_kaldi_asr_tpu_torch.train.optim import (  # noqa: E402
    named_leaves,
)


def _t(a, dtype=None):
    t = torch.as_tensor(a)
    return t if dtype is None else t.to(dtype)


def _grad_params(params):
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    return params


def _grads(params):
    return {"/".join(map(str, path)): (leaf.grad.clone()
                                       if leaf.grad is not None else None)
            for path, leaf in named_leaves(params)}


def _messages(cases):
    """{name: the ValueError's message, or None} of each call."""
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def run_sp(inputs, rank, n):
    from pytorch_kaldi_asr_tpu_torch.parallel import sequence as sp
    from pytorch_kaldi_asr_tpu_torch.train.state import step_rngs

    mesh = sp.make_seq_mesh(n)
    axis = mesh.axis("seq")
    out = {}
    x = torch.arange(4 * n, dtype=torch.float32).reshape(1, 4 * n, 1)
    left, right = sp.halo_exchange(x[:, 4 * rank:4 * rank + 4], 2, 1, axis)
    out["halo"] = torch.cat([left, right], dim=1)
    for name, case in inputs.items():
        cfg = TransformerConfig(**case["cfg"])
        kind = case["kind"]
        src, mask = _t(case["src"]), _t(case["mask"])
        if kind == "fwd":
            with torch.no_grad():
                out[name] = sp.sp_encode(case["params"], cfg, src, mask, mesh)
        elif kind == "grad":
            params = _grad_params(case["params"])
            enc = sp.sp_encode(params, cfg, src, mask, mesh, train=True)
            (enc ** 2).sum().backward()
            for _, leaf in named_leaves(params):
                collectives.all_reduce_(leaf.grad, axis)
            out[name] = _grads(params)
        elif kind == "ce":
            params = _grad_params(case["params"])
            utt = _t(case["utt_valid"])
            tgt = _t(case["tgt"], torch.int64)
            loss, nc, nf = sp.sp_frame_ce_loss(params, cfg, src, mask, tgt,
                                               mesh, train=True,
                                               utt_valid=utt)
            (loss / nf).backward()
            for _, leaf in named_leaves(params):
                collectives.all_reduce_(leaf.grad, axis)
            with torch.no_grad():
                evals = sp.sp_frame_ce_loss(params, cfg, src, mask, tgt,
                                            mesh, utt_valid=utt)
            out[name] = {"sums": [float(loss), float(nc), float(nf)],
                         "eval": [float(v) for v in evals],
                         "grads": _grads(params)}
        elif kind == "dropout":
            with torch.no_grad():
                out[name] = {
                    "infer": sp.sp_encode(case["params"], cfg, src, mask,
                                          mesh),
                    "a": sp.sp_encode(case["params"], cfg, src, mask, mesh,
                                      train=True, rngs=step_rngs(7, 0)),
                    "a2": sp.sp_encode(case["params"], cfg, src, mask, mesh,
                                       train=True, rngs=step_rngs(7, 0)),
                    "b": sp.sp_encode(case["params"], cfg, src, mask, mesh,
                                      train=True, rngs=step_rngs(8, 0)),
                    "none": sp.sp_encode(case["params"], cfg, src, mask,
                                         mesh, train=True, rngs=None)}
        elif kind == "errors":
            params = case["params"]
            out[name] = _messages({
                "band": lambda: sp.sp_banded_encode(
                    params, cfg.replace(encoder_sub_sequence=(-12, 0)), src,
                    mask, mesh),
                "length": lambda: sp.sp_banded_encode(
                    params, cfg, src[:, :-4], mask[:, :-4], mesh),
                "encoder": lambda: sp.sp_encode(
                    params, cfg.replace(encoder_type="tdnnf"), src, mask,
                    mesh),
                "fold": lambda: sp.sp_frame_ce_loss(
                    {"encoder": params}, cfg.replace(src_fold=2), src, mask,
                    mask.long(), mesh),
            })
    rngs = sp.per_shard_rng(step_rngs(0, 0), rank)
    out["streams"] = torch.tensor([rngs.seed() for _ in range(4)])
    return out


def run_dptp(inputs, rank, n):
    from pytorch_kaldi_asr_tpu_torch.parallel.mesh import (
        gather_params,
        make_mesh,
        param_shardings,
        shard_batch_arrays,
        shard_params,
    )
    from pytorch_kaldi_asr_tpu_torch.train.state import (
        create_train_state,
        eval_step,
        train_step,
    )

    out = {}
    meshes = {}
    for name, case in inputs.items():
        key = tuple(case["mesh"])
        if key not in meshes:
            meshes[key] = make_mesh(*key, ranks=list(range(key[0] * key[1])))
    for key, mesh in meshes.items():
        if mesh.member:
            (out[f"rows{key}"],) = shard_batch_arrays(
                mesh, torch.arange(32).reshape(8, 4))
    for name, case in inputs.items():
        mesh = meshes[tuple(case["mesh"])]
        if not mesh.member:
            continue
        cfg = TransformerConfig(**case["cfg"])
        if case.get("loop"):  # train_model(mesh=) over in-memory batches
            from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader
            from pytorch_kaldi_asr_tpu_torch.train.loop import train_model

            loop = case["loop"]
            save = Path(loop["dir"]) / f"rank{rank}"
            res = train_model(
                case["params"], cfg,
                BatchLoader(loop["triples"], loop["batch"], mode="drop"),
                BatchLoader(loop["triples"], loop["batch"], mode="all"),
                BatchLoader(loop["triples"], loop["batch"], mode="all"),
                str(save), epochs=loop["epochs"], device="cpu", mesh=mesh)
            out[name] = {"best_epoch": res.best_epoch,
                         "best_accu": res.best_accu,
                         "params": res.best_params,
                         "written": sorted(p.name for p in save.iterdir())}
            continue
        specs = param_shardings(case["params"], mesh)
        state = create_train_state(shard_params(case["params"], mesh))
        data = shard_batch_arrays(mesh, *(_t(a) for a in case["data"]))
        losses = [float(train_step(state, cfg, *data, mesh=mesh)["loss"])
                  for _ in range(case["steps"])]
        valid = torch.ones(data[0].shape[0])
        ev = eval_step(state.params, cfg, *data, valid, mesh=mesh)
        out[name] = {"losses": losses,
                     "eval": {k: float(v) for k, v in ev.items()},
                     "params": gather_params(state.params, specs, mesh),
                     "local_shapes": {"/".join(map(str, p)): tuple(l.shape)
                                      for p, l in named_leaves(state.params)}}
    return out


def run_pp(inputs, rank, n):
    from pytorch_kaldi_asr_tpu_torch.parallel import pipeline as pp
    from pytorch_kaldi_asr_tpu_torch.train.state import step_rngs

    out = {}
    meshes = {}
    for name, case in inputs.items():
        key = (case["pipe"], case.get("data", 1))
        if key not in meshes:
            meshes[key] = pp.make_pipe_mesh(
                pipe=key[0], data=key[1], ranks=list(range(key[0] * key[1])))
    for name, case in inputs.items():
        mesh = meshes[(case["pipe"], case.get("data", 1))]
        if not mesh.member:
            continue
        cfg = TransformerConfig(**case["cfg"])
        kind = case["kind"]
        if kind == "none":
            continue
        src, mask = _t(case["src"]), _t(case["mask"])
        micro = case.get("micro")
        if kind == "fwd":
            params = pp.stage_params(case["params"], cfg, mesh)
            with torch.no_grad():
                enc = pp.pp_banded_encode(params, cfg, src, mask, mesh,
                                          n_microbatches=micro)
            out[name] = {"enc": enc,
                         "rows": pp.pp_rows(src.shape[0], micro or
                                            case["pipe"], mesh)}
        elif kind == "grad":
            params = _grad_params(pp.stage_params(case["params"], cfg, mesh))
            tgt = _t(case["tgt"], torch.int64)
            loss, nc, nf = pp.pp_frame_ce_loss(params, cfg, src, mask, tgt,
                                               mesh, n_microbatches=micro)
            (loss / nf).backward()
            for _, leaf in named_leaves(params):
                collectives.all_reduce_(leaf.grad, mesh.axis("data"))
            out[name] = {"loss": float(loss / nf), "grads": _grads(params),
                         "stage": mesh.index("pipe")}
        elif kind == "utt_valid":
            tgt = _t(case["tgt"], torch.int64)
            with torch.no_grad():
                got = pp.pp_frame_ce_loss(case["params"], cfg, src, mask, tgt,
                                          mesh, utt_valid=_t(case["utt"]))
                full = pp.pp_frame_ce_loss(case["params"], cfg, src, mask,
                                           tgt, mesh)
            out[name] = {"got": [float(v) for v in got],
                         "full": [float(v) for v in full]}
        elif kind == "dropout":
            params = _grad_params(pp.stage_params(case["params"], cfg, mesh))
            tgt = _t(case["tgt"], torch.int64)
            loss, _, nf = pp.pp_frame_ce_loss(params, cfg, src, mask, tgt,
                                              mesh, train=True,
                                              rngs=step_rngs(0, 0))
            (loss / nf).backward()
            with torch.no_grad():
                l2, _, _ = pp.pp_frame_ce_loss(params, cfg, src, mask, tgt,
                                               mesh, train=True,
                                               rngs=step_rngs(1, 0))
            gn = sum(float((leaf.grad ** 2).sum())
                     for _, leaf in named_leaves(params)
                     if leaf.grad is not None)
            out[name] = {"l1": float(loss / nf), "l2": float(l2 / nf),
                         "gn": gn}
        elif kind == "errors":
            params = case["params"]
            bad = meshes[tuple(case["bad_mesh"])]
            if not bad.member:
                continue
            out[name] = _messages({
                "stages": lambda: pp.pp_banded_encode(params, cfg, src, mask,
                                                      bad),
                "micro": lambda: pp.pp_banded_encode(params, cfg, src, mask,
                                                     mesh, n_microbatches=3),
            })
    return out


def run_sp_cuda(inputs, rank, n):
    """The SP step of a small conformer AM on ranks sharing the card (gloo
    with CUDA tensors) against one rank's step on the card."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.models import am
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.ops.launches import launch_counts
    from pytorch_kaldi_asr_tpu_torch.parallel import sequence as sp
    from pytorch_kaldi_asr_tpu_torch.train.state import sum_grads

    device = torch.device("cuda", 0)
    cfg = TransformerConfig(src_dim=8, vocab_size=11, en_layers=2, n_head=2,
                            en_d_model=32, d_k=16, d_v=16,
                            encoder_max_len=128, encoder_sub_sequence=(-16, 8),
                            en_dropout=0.0, encoder_type="conformer",
                            conformer_kernel=7)
    init = am.init_am(torch.Generator().manual_seed(0), cfg, 11)
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.normal(size=(2, 128, 8)).astype(np.float32))
    mask = torch.from_numpy((np.arange(128)[None, :] < np.array([
        [120], [57]])).astype(np.uint8))
    tgt = torch.from_numpy(rng.integers(0, 11, size=(2, 128)))
    src, mask, tgt = (x.to(device) for x in (src, mask, tgt))

    def params():
        return _grad_params(tree_map(lambda t: t.to(device, copy=True),
                                     init))

    mesh = sp.make_seq_mesh(n)
    mine = params()
    loss, _, nf = sp.sp_frame_ce_loss(mine, cfg, src, mask, tgt, mesh,
                                      train=True)
    (loss / nf).backward()
    sum_grads(mine, mesh.axis("seq"))
    out = {"launches": launch_counts(), "loss": float((loss / nf).detach())}
    if rank == 0:
        one = params()
        l1, _, n1 = am.frame_ce_loss(one, cfg, src, mask, tgt, train=True)
        (l1 / n1).backward()
        out["one_loss"] = float((l1 / n1).detach())
        out["grad_rel"] = max(
            float((a.grad - b.grad).abs().max() / b.grad.abs().max())
            for (_, a), (_, b) in zip(named_leaves(mine), named_leaves(one)))
    return out


def run_psum(inputs, rank, n):
    axis = collectives.Axis("world", list(range(n)), rank,
                            torch.distributed.group.WORLD)
    total = collectives.psum(torch.tensor([float(rank + 1)]), axis)
    return {"psum": float(total)}


SUITES = {"sp": run_sp, "dptp": run_dptp, "pp": run_pp, "psum": run_psum,
          "sp_cuda": run_sp_cuda}


def main(argv):
    suite, job, n, port, work, device = argv
    rank, n, work = int(job) - 1, int(n), Path(work)
    multihost.initialize(f"127.0.0.1:{port}", n, rank, backend="gloo",
                         device=device)
    inputs = torch.load(work / "inputs.pt", weights_only=False) \
        if (work / "inputs.pt").exists() else {}
    out = SUITES[suite](inputs, rank, n)
    torch.save(out, work / f"out.{rank}.pt")
    torch.distributed.destroy_process_group()
    print(f"PARALLEL_WORKER_OK {suite} {rank}/{n}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
