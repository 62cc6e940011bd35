"""The port's job packaging and multi-process bootstrap (counterpart of
``tests/test_job_deployment.py``): the bundle, the launcher's ``DKT_*``
env, the dry-run commands, the single-process no-op, and how
``multihost.initialize`` resolves its arguments and backend. Everything
but the actual ssh hop is tested offline; the multi-process launches are
in ``test_torch_sync_dp.py``."""

import os
import subprocess
import tarfile
import time

import pytest
import torch.distributed as dist

from distkeras_tpu_torch.job_deployment import (
    Job,
    local_address,
    run_local_ranks,
)
from distkeras_tpu_torch.parallel import multihost


@pytest.fixture
def script(tmp_path):
    p = tmp_path / "train.py"
    p.write_text(
        "import sys\n"
        "from distkeras_tpu_torch.parallel import multihost\n"
        "print('pid', multihost.initialize(device='cpu'), sys.argv[1:])\n"
        "print('rank', multihost.process_id(), multihost.num_processes())\n"
        "print('MARKER_OK')\n"
    )
    return str(p)


def test_package_contents(tmp_path, script):
    job = Job(script, num_hosts=4, coordinator_address="10.0.0.1:9999",
              script_args=["--epochs", "3"])
    bundle = job.package(str(tmp_path / "job.tar.gz"))
    with tarfile.open(bundle) as tar:
        names = tar.getnames()
    assert "train.py" in names
    assert "run.sh" in names
    assert "distkeras_tpu_torch/trainers.py" in names
    assert "distkeras_tpu_torch/parallel/multihost.py" in names
    assert "distkeras_tpu_torch/kernels/csrc/adam_fused.cu" in names
    assert not any(n.startswith("distkeras_tpu/") for n in names)
    assert not any("__pycache__" in n or "/_build" in n for n in names)

    text = job.launcher_text()
    assert "DKT_COORDINATOR_ADDRESS=10.0.0.1:9999" in text
    assert "DKT_NUM_PROCESSES=4" in text
    assert "DKT_PROCESS_ID=${1:-0}" in text
    assert "DKT_BACKEND" not in text
    assert "train.py --epochs 3" in text


def test_launcher_exports_a_named_backend(script):
    text = Job(script, num_hosts=2, backend="gloo").launcher_text()
    assert "export DKT_BACKEND=gloo" in text


def test_launch_commands_one_per_host(script):
    job = Job(script, num_hosts=3)
    cmds = job.launch_commands(remote_dir="/opt/job")
    assert len(cmds) == 3
    assert cmds[0].endswith("run.sh 0") and cmds[2].endswith("run.sh 2")


def test_submit_dry_run_emits_scp_and_ssh(script):
    job = Job(script, num_hosts=2)
    plans = job.submit(["gpu-host-a", "gpu-host-b"], ssh_user="me",
                       dry_run=True)
    assert len(plans) == 2
    scp, ssh = plans[1]
    assert scp[0] == "scp" and scp[-1] == "me@gpu-host-b:dkt_job.tar.gz"
    assert ssh[0] == "ssh" and "run.sh 1" in ssh[-1]


@pytest.mark.parametrize("hosts,user", [(["only-one"], None),
                                        (["a", "b;rm"], None),
                                        (["a", "b"], "bad user")])
def test_submit_refuses_bad_hosts(script, hosts, user):
    job = Job(script, num_hosts=2)
    with pytest.raises(ValueError):
        job.submit(hosts, ssh_user=user, dry_run=True)


def test_run_local_executes_bundle(tmp_path, script):
    job = Job(script, num_hosts=1, script_args=["--flag"])
    proc = job.run_local(workdir=str(tmp_path / "wd"), timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "MARKER_OK" in proc.stdout
    # one process: initialize() is a no-op and the job is rank 0 of 1
    assert "pid False" in proc.stdout
    assert "rank 0 1" in proc.stdout


def test_run_local_ranks_shares_cores_and_absolutizes_paths(tmp_path,
                                                            capsys):
    """Every rank of a local job runs in a directory of its own, with its
    share of the host's cores; a path flag's value reaches it absolute,
    and the label's line and rank 0's output are printed. A failing rank
    raises with its output."""
    script = tmp_path / "ranks.py"
    script.write_text(
        "import os, sys\n"
        "print('RANK', os.environ['DKT_PROCESS_ID'], "
        "os.environ['OMP_NUM_THREADS'], sys.argv[1:])\n"
        "sys.exit(3 if sys.argv[-1] == 'fail' else 0)\n")
    run_local_ranks(str(script), 2, ["--out", "rel/x", "keep"],
                    path_flags=("--out",), label="demo", device="cpu")
    threads = str(max(1, (os.cpu_count() or 1) // 2))
    want = ["--out", os.path.abspath("rel/x"), "keep"]
    if "OMP_NUM_THREADS" in os.environ:
        threads = os.environ["OMP_NUM_THREADS"]
    assert capsys.readouterr().out == (
        f"demo: 2 rank processes over gloo on the CPU\n"
        f"RANK 0 {threads} {want}\n")
    with pytest.raises(RuntimeError, match="rank 0 of 2 exited 3"):
        run_local_ranks(str(script), 2, ["fail"], device="cpu")


_WAITER = (
    "import os, sys, time\n"
    "rank = os.environ['DKT_PROCESS_ID']\n"
    "with open(os.path.join(sys.argv[1], 'pid' + rank), 'w') as f:\n"
    "    f.write(str(os.getpid()))\n"
    "if rank == '1' and sys.argv[2] == 'fail':\n"
    "    time.sleep(1.0)\n"
    "    sys.exit(3)\n"
    "time.sleep(600)\n"
)


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.mark.parametrize("how", ["fail", "timeout"])
def test_run_local_all_ends_every_rank(tmp_path, how):
    """The first rank to exit non-zero, or the launch's timeout, ends the
    launch at once: the peers still waiting are killed, not left to wait
    for the group's timeout, and the error names the rank that failed."""
    script = tmp_path / "wait.py"
    script.write_text(_WAITER)
    job = Job(str(script), num_hosts=2, coordinator_address=local_address(),
              script_args=[str(tmp_path), how])
    want = RuntimeError if how == "fail" else subprocess.TimeoutExpired
    t0 = time.monotonic()
    with pytest.raises(want, match="rank 1 of 2 exited 3" if how == "fail"
                       else None):
        job.run_local_all(str(tmp_path / "wd"), timeout=5.0)
    assert time.monotonic() - t0 < 30
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert all(_gone(pid) for pid in pids), pids


def test_local_ranks_share_the_kernel_build_dir(tmp_path, script):
    """A local rank's unpacked package builds its kernels into this
    package's build directory, so a launch reuses what the checkout has
    built."""
    from distkeras_tpu_torch.kernels.build import BUILD_DIR

    Job(script).run_local(workdir=str(tmp_path / "wd"), timeout=60)
    link = tmp_path / "wd" / "distkeras_tpu_torch" / "kernels" / "_build"
    assert link.is_symlink() and link.resolve() == BUILD_DIR.resolve()


def test_missing_script_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Job(str(tmp_path / "nope.py"))


@pytest.fixture
def fake_init(monkeypatch):
    calls = {}

    def init(backend, **kw):
        calls.update(backend=backend, **kw)

    monkeypatch.setattr(dist, "init_process_group", init)
    for env in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
                multihost.ENV_PROCESS_ID, multihost.ENV_BACKEND):
        monkeypatch.delenv(env, raising=False)
    return calls


def test_multihost_env_resolution(monkeypatch, fake_init):
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "c:1")
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(multihost.ENV_PROCESS_ID, "2")
    assert multihost.initialize(device="cpu") is True
    assert fake_init == {
        "backend": "gloo",
        "init_method": "tcp://c:1",
        "world_size": 4,
        "rank": 2,
    }
    # single-process env: no-op
    fake_init.clear()
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "1")
    assert multihost.initialize() is False
    assert fake_init == {}


def test_multihost_explicit_args_beat_env(monkeypatch, fake_init):
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "c:1")
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(multihost.ENV_PROCESS_ID, "2")
    assert multihost.initialize("h:7", 2, 1, backend="gloo", timeout=30)
    assert (fake_init["init_method"], fake_init["world_size"],
            fake_init["rank"]) == ("tcp://h:7", 2, 1)
    assert fake_init["timeout"].total_seconds() == 30


def test_multihost_backend_resolution(monkeypatch, fake_init):
    """explicit backend > DKT_BACKEND > the device (NCCL for CUDA, gloo for
    the CPU); without a GPU, device=None raises as every entry point
    does — never a quiet switch to the CPU."""
    monkeypatch.setenv(multihost.ENV_BACKEND, "gloo")
    multihost.initialize("h:1", 2, 0)
    assert fake_init["backend"] == "gloo"
    multihost.initialize("h:1", 2, 0, backend="nccl")
    assert fake_init["backend"] == "nccl"
    monkeypatch.delenv(multihost.ENV_BACKEND)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multihost.initialize("h:1", 2, 0)
