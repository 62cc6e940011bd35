"""Job packaging & deployment — ship a training script to N ranks
(PyTorch port of ``distkeras_tpu.job_deployment``).

The reference packaged a training script and remote-submitted it via
ssh + spark-submit to a Spark cluster. Here every rank runs the same
program, one process per rank (the ``torchrun`` model), and joins one
``torch.distributed`` process group, so a Job

1. **packages** the user script together with the ``distkeras_tpu_torch``
   package and a generated per-rank launcher into one tarball;
2. **emits per-host launch commands** that export the coordinator env vars
   (``DKT_COORDINATOR_ADDRESS`` / ``DKT_NUM_PROCESSES`` /
   ``DKT_PROCESS_ID``, and ``DKT_BACKEND`` when a backend is named),
   consumed by ``parallel.multihost.initialize``, and exec the script;
3. **submits** over ssh (scp bundle, run launcher) or **runs locally**:
   ``run_local`` once per process id, from concurrent threads, is the
   local multi-process path (N CPU ranks over gloo, or N ranks sharing a
   host's cards).

Everything except the actual ssh execution is pure local logic, so it is
fully testable offline; ``submit(dry_run=True)`` returns the exact command
lists without touching the network.
"""

from __future__ import annotations

import os
import re
import shlex
import subprocess
import sys
import tarfile
import tempfile

_HOST_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9.\-]*$")
_USER_RE = re.compile(r"^[A-Za-z0-9._\-]+$")


def _quote_remote_dir(remote_dir: str) -> str:
    """Shell-quote a remote path for interpolation into ssh command strings,
    preserving a leading ``~/`` (quoting it would defeat tilde expansion)."""
    if remote_dir.startswith("~/"):
        return "~/" + shlex.quote(remote_dir[2:])
    return shlex.quote(remote_dir)


_LAUNCHER = """#!/bin/sh
# generated by distkeras_tpu_torch.job_deployment.Job — per-rank launcher
# usage: run.sh <process_id>
set -e
cd "$(dirname "$0")"
export DKT_COORDINATOR_ADDRESS={coordinator}
export DKT_NUM_PROCESSES={num_hosts}
export DKT_PROCESS_ID=${{1:-0}}
{backend}export PYTHONPATH="$(pwd):$PYTHONPATH"
exec {python} {script} {script_args}
"""


def _skip_built(info):
    """Leave byte code and built kernels out of the bundle."""
    parts = info.name.split("/")
    if "__pycache__" in parts or "_build" in parts:
        return None
    return info


class Job:
    """A deployable training job: script + framework + launch recipe.
    ``num_hosts`` is the number of ranks (one process each);
    ``backend``, when given, is exported as ``DKT_BACKEND`` ("gloo" for
    CPU ranks or ranks sharing one card, "nccl" for one rank per card)."""

    def __init__(
        self,
        script: str,
        num_hosts: int = 1,
        coordinator_address: str = "localhost:12345",
        script_args=(),
        python: str | None = None,
        extra_files=(),
        backend: str | None = None,
    ):
        self.script = os.path.abspath(script)
        if not os.path.isfile(self.script):
            raise FileNotFoundError(self.script)
        self.num_hosts = int(num_hosts)
        self.coordinator_address = coordinator_address
        self.script_args = [str(a) for a in script_args]
        # default to this interpreter: run_local stays inside the venv; for
        # remote pods pass the pod hosts' python explicitly
        self.python = python or sys.executable
        self.extra_files = [os.path.abspath(f) for f in extra_files]
        self.backend = backend

    # -- packaging -----------------------------------------------------------

    def launcher_text(self) -> str:
        return _LAUNCHER.format(
            coordinator=shlex.quote(self.coordinator_address),
            num_hosts=self.num_hosts,
            backend=(f"export DKT_BACKEND={shlex.quote(self.backend)}\n"
                     if self.backend else ""),
            python=shlex.quote(self.python),
            script=shlex.quote(os.path.basename(self.script)),
            script_args=" ".join(shlex.quote(a) for a in self.script_args),
        )

    def package(self, out_path: str) -> str:
        """Write the job bundle tarball: user script, extra files, the
        ``distkeras_tpu_torch`` package itself (without its built
        kernels: a rank builds them from the sources at first use), and
        the generated ``run.sh``."""
        out_path = os.path.abspath(out_path)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        pkg_root = os.path.dirname(os.path.abspath(__file__))
        with tarfile.open(out_path, "w:gz") as tar:
            tar.add(self.script, arcname=os.path.basename(self.script))
            for f in self.extra_files:
                tar.add(f, arcname=os.path.basename(f))
            tar.add(
                pkg_root,
                arcname="distkeras_tpu_torch",
                filter=_skip_built,
            )
            with tempfile.NamedTemporaryFile("w", suffix=".sh", delete=False) as f:
                f.write(self.launcher_text())
                tmp = f.name
            os.chmod(tmp, 0o755)
            tar.add(tmp, arcname="run.sh")
            os.unlink(tmp)
        return out_path

    # -- launching -----------------------------------------------------------

    def launch_commands(self, remote_dir: str = "~/dkt_job"):
        """Per-host command lines (host i runs process id i; host 0 is the
        coordinator: it writes the synchronous trainer's checkpoints)."""
        rd = _quote_remote_dir(remote_dir)
        return [f"cd {rd} && sh run.sh {i}" for i in range(self.num_hosts)]

    def submit(
        self,
        hosts,
        remote_dir: str = "~/dkt_job",
        ssh_user: str | None = None,
        dry_run: bool = False,
    ):
        """scp the bundle to each host, unpack, launch (reference parity:
        Job packaged + remote spark-submit over ssh). ``dry_run`` returns
        the exact commands without executing anything."""
        hosts = list(hosts)
        if len(hosts) != self.num_hosts:
            raise ValueError(
                f"{len(hosts)} hosts given but num_hosts={self.num_hosts}"
            )
        for host in hosts:
            if not _HOST_RE.match(host):
                raise ValueError(f"invalid ssh host {host!r}")
        if ssh_user is not None and not _USER_RE.match(ssh_user):
            raise ValueError(f"invalid ssh user {ssh_user!r}")
        remote_dir_q = _quote_remote_dir(remote_dir)
        # unique per-call bundle path: concurrent submits (or other users of
        # the shared temp dir) must not clobber each other's tarball
        fd, bundle = tempfile.mkstemp(prefix="dkt_job_", suffix=".tar.gz")
        os.close(fd)
        commands = []
        for i, host in enumerate(hosts):
            target = f"{ssh_user}@{host}" if ssh_user else host
            commands.append(
                [
                    ["scp", bundle, f"{target}:dkt_job.tar.gz"],
                    [
                        "ssh",
                        target,
                        f"mkdir -p {remote_dir_q} && "
                        f"tar xzf dkt_job.tar.gz -C {remote_dir_q} && "
                        f"cd {remote_dir_q} && nohup sh run.sh {i} "
                        f"> run_{i}.log 2>&1 &",
                    ],
                ]
            )
        if dry_run:
            os.unlink(bundle)
            return commands
        self.package(bundle)
        try:
            for host_cmds in commands:
                for cmd in host_cmds:
                    subprocess.run(cmd, check=True)
        finally:
            os.unlink(bundle)
        return commands

    def run_local(
        self,
        workdir: str | None = None,
        process_id: int = 0,
        timeout: float | None = None,
    ):
        """Unpack the bundle into ``workdir`` and run it in-place — the
        single-process smoke path, and, called once per process id from
        concurrent threads, the local multi-process path (each rank gets
        its own workdir and DKT_PROCESS_ID). Returns the CompletedProcess;
        raises subprocess.TimeoutExpired past ``timeout`` seconds (the
        rank is killed)."""
        workdir = workdir or tempfile.mkdtemp(prefix="dkt_job_")
        bundle = os.path.join(workdir, "bundle.tar.gz")
        self.package(bundle)
        with tarfile.open(bundle) as tar:
            try:
                tar.extractall(workdir, filter="data")
            except TypeError:
                # extraction filters only exist from 3.10.12/3.11.4/3.12;
                # the bundle is self-authored, so plain extraction is safe
                tar.extractall(workdir)
        return subprocess.run(
            ["sh", "run.sh", str(process_id)],
            cwd=workdir,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
