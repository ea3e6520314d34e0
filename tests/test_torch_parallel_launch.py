"""The port's job launcher (parallel/launch.py: ``--gang``, ``--hosts``,
``--backend``, ``-q``, ``-l``), its batch-scheduler path
(parallel/batch.py) and parallel/multihost.py, against the JAX package's
(tests/test_{gang,remote,batch}_launch.py): each case runs both launchers
on the same commands, and their logs and wrappers must be the same up to
times and paths.  The schedulers and ssh are fakes that run the jobs here
($PKA_QSUB, $PKA_SBATCH, $PKA_PBS_QSUB, $PKA_SSH); a two-process gloo
world joins through ``multihost.initialize`` and sums one tensor."""

import os
import re
import stat
import time

import pytest
import torch

from pytorch_kaldi_asr_tpu.parallel import batch as jax_batch
from pytorch_kaldi_asr_tpu.parallel import launch as jax_launch
from pytorch_kaldi_asr_tpu.parallel import multihost as jax_multihost
from pytorch_kaldi_asr_tpu_torch.parallel import batch, launch, multihost
from tests.test_batch_launch import FAKE_QSUB, FAKE_SBATCH
from tests.test_remote_launch import FAKE_SSH
from tests.torch_parallel_helpers import run_world

torch.set_num_threads(1)

PACKAGES = (("jax", jax_launch, jax_batch), ("port", launch, batch))


def _script(path, body):
    path.write_text("#!/bin/bash\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _normal(text, root):
    """A log or wrapper without its times and paths."""
    text = text.replace(str(root), "ROOT")
    text = re.sub(r"(# Started at|# Ended \(code -?\d+\) at) .*", r"\1 T",
                  text)
    text = re.sub(r"# Accounting: time=\d+", "# Accounting: time=N", text)
    return text.replace("pytorch_kaldi_asr_tpu_torch.parallel.batch",
                        "pytorch_kaldi_asr_tpu.parallel.batch")


def _both(tmp_path, monkeypatch, argv_of, logs, setup=None):
    """Run the launcher of each package on ``argv_of(dir)`` in its own
    directory; returns ({package: exit code}, {package: [logs]})."""
    codes, texts = {}, {}
    for name, mod, bmod in PACKAGES:
        root = tmp_path / name
        root.mkdir()
        if setup is not None:
            setup(root, bmod)
        monkeypatch.chdir(root)
        codes[name] = mod.launch(argv_of(root))
        texts[name] = [_normal((root / log).read_text(), root)
                       for log in logs]
    assert texts["port"] == texts["jax"]
    return codes, texts


GANG_SCRIPTS = {
    # rank 2 fails at once, rank 1 would sleep: the gang kills it
    "kill": ([], 'if [ "$1" = "2" ]; then exit 7; fi\nsleep 60\n', 1),
    # the first attempt's rank 2 fails; with one retry the array reruns
    "relaunch": (["--retries", "1"],
                 'echo attempt-marker-$1\nif [ ! -f ../flag ]; then\n'
                 '  if [ "$1" = "2" ]; then touch ../flag; exit 1; fi\n'
                 '  exit 0\nfi\nexit 0\n', 0),
    # a preempted rank (75) takes the resubmit budget
    "preempt": (["--resubmit", "1"],
                'if [ ! -f ../flag ]; then touch ../flag; exit 75; fi\n'
                'exit 0\n', 0),
    # classified by the initiating rank: its survivor's -15 is not a retry
    "initiator": (["--resubmit", "1"],
                  'if [ ! -f ../flag ]; then\n'
                  '  if [ "$1" = "1" ]; then touch ../flag; exit 75; fi\n'
                  '  sleep 60\nfi\nexit 0\n', 0),
}


@pytest.mark.parametrize("name", list(GANG_SCRIPTS))
def test_gang_as_jax(tmp_path, monkeypatch, name):
    opts, body, want = GANG_SCRIPTS[name]
    for mod in (jax_launch, launch):
        monkeypatch.setattr(mod, "GANG_KILL_GRACE", 3.0)

    def argv(root):
        (root / "run").mkdir()
        flag = root / "flag"
        if flag.exists():
            flag.unlink()
        return ["--gang", *opts, "JOB=1:2", "run/log.JOB.txt", "bash",
                _script(root / "job.sh", body), "JOB"]

    t0 = time.time()
    codes, texts = _both(tmp_path, monkeypatch, argv,
                         ["run/log.1.txt", "run/log.2.txt"])
    assert codes == {"jax": want, "port": want}
    assert time.time() - t0 < 60
    if name == "kill":
        assert "Gang: killed after job 2 exited 7" in texts["port"][0]


def test_hosts_round_robin_as_jax(tmp_path, monkeypatch):
    def setup(root, _):
        ssh = root / "fake_ssh"
        ssh.write_text(FAKE_SSH)
        ssh.chmod(ssh.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PKA_SSH", str(ssh))
        (root / "machines").write_text("alpha\n# comment\nbeta  # b\n")

    codes, texts = _both(
        tmp_path, monkeypatch,
        lambda root: ["--hosts", "machines", "JOB=1:4", "log/job.JOB.log",
                      "echo", "job-JOB"],
        [f"log/job.{j}.log" for j in range(1, 5)], setup)
    assert codes == {"jax": 0, "port": 0}
    assert "HOST=alpha" in texts["port"][0] and "HOST=beta" in texts["port"][1]
    assert launch.remote_command("n1", ["echo", "a b"], cwd="/w d",
                                 ssh="ssh") == jax_launch.remote_command(
        "n1", ["echo", "a b"], cwd="/w d", ssh="ssh")


@pytest.mark.parametrize("backend", ["sge", "slurm", "pbs"])
def test_backend_as_jax(tmp_path, monkeypatch, backend):
    def setup(root, bmod):
        env_override, _, var = bmod.BACKENDS[backend]
        fake = root / f"fake_{backend}"
        fake.write_text(FAKE_SBATCH if backend == "slurm"
                        else FAKE_QSUB.replace("{VAR}", var))
        fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv(env_override, str(fake))

    codes, texts = _both(
        tmp_path, monkeypatch,
        lambda root: ["--backend", backend, "-q", "all.q", "-l", "gpu=1",
                      "JOB=1:3", "log/arr.JOB.log", "bash", "-c",
                      "echo task-JOB; exit $((JOB - 1))"],
        ["log/q/job.sh"] + [f"log/arr.{j}.log" for j in (1, 2, 3)], setup)
    assert codes == {"jax": 1, "port": 1}  # jobs 2 and 3 fail
    assert "task-3" in texts["port"][3]
    for kw in (dict(queue="all.q", resources=["gpu=1", "ram=2G"]),
               dict(max_jobs=3)):
        assert batch.submit_argv(backend, "/q/job.sh", [1, 8], **kw) \
            == jax_batch.submit_argv(backend, "/q/job.sh", [1, 8], **kw)


def test_wrapper_remaps_oom_and_sync_timeout(tmp_path, capsys):
    import subprocess

    script = batch.write_wrapper(str(tmp_path / "q"), "sge",
                                 str(tmp_path / "t.JOB.log"),
                                 ["bash", "-c", "exit 137"],
                                 cwd=str(tmp_path))
    proc = subprocess.run(["bash", script],
                          env=dict(os.environ, SGE_TASK_ID="5"))
    assert proc.returncode == 100
    assert (tmp_path / "q" / "status.5").read_text().strip() == "100"
    codes = batch.wait_sync(str(tmp_path), [1, 2], poll=0.01, timeout=0.1)
    assert codes == {1: -1, 2: -1}
    assert "timed out" in capsys.readouterr().err


def test_multihost_two_processes_psum(tmp_path):
    """Two gloo processes join one world through ``multihost.initialize``
    (from the launcher's ``--gang`` array) and sum one tensor."""
    out = run_world("psum", 2, tmp_path)
    assert [o["psum"] for o in out] == [3.0, 3.0]


def test_multihost_refusals_and_shards(monkeypatch):
    assert multihost.initialize() == (0, 1)  # one process: a no-op
    with pytest.raises(ValueError, match="use gloo on the CPU"):
        multihost.check_backend("nccl", "cpu", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one "
                       "card: use the gloo backend"):
        multihost.check_backend("nccl", "cuda", 8)
    multihost.check_backend("gloo", "cuda", 8)  # gloo shares the card
    multihost.check_backend("nccl", "cuda", 1)
    items = list(range(11))
    for i in range(3):
        assert multihost.shard_for_process(items, i, 3) == \
            jax_multihost.shard_for_process(items, i, 3)
