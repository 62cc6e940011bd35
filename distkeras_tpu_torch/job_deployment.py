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
   ``run_local`` runs one rank; ``run_local_all`` is the local
   multi-process path (N CPU ranks over gloo, or N ranks sharing a host's
   cards), starting every rank and ending them all when one fails.

Everything except the actual ssh execution is pure local logic, so it is
fully testable offline; ``submit(dry_run=True)`` returns the exact command
lists without touching the network.
"""

from __future__ import annotations

import os
import re
import shlex
import socket
import subprocess
import sys
import tarfile
import tempfile
import time

_HOST_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9.\-]*$")
_USER_RE = re.compile(r"^[A-Za-z0-9._\-]+$")
#: seconds a local launch may take by default, and the seconds an
#: example's rank waits for a peer (``multihost.initialize(timeout=)``)
RANK_TIMEOUT = 900.0


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
        kernels: a remote rank builds them from the sources at first use;
        a local one shares this checkout's), and the generated
        ``run.sh``."""
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

    def _unpack(self, bundle: str, workdir: str) -> str:
        """Extract ``bundle`` into ``workdir`` and point its package's
        kernel build directory at this package's: a rank on this host
        then reuses the kernels this checkout has built, and what it
        builds stays for the next launch."""
        os.makedirs(workdir, exist_ok=True)
        with tarfile.open(bundle) as tar:
            try:
                tar.extractall(workdir, filter="data")
            except TypeError:
                # extraction filters only exist from 3.10.12/3.11.4/3.12;
                # the bundle is self-authored, so plain extraction is safe
                tar.extractall(workdir)
        from distkeras_tpu_torch.kernels.build import BUILD_DIR

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        link = os.path.join(workdir, "distkeras_tpu_torch", "kernels",
                            "_build")
        if not os.path.lexists(link):
            os.symlink(BUILD_DIR, link)
        return workdir

    def run_local(
        self,
        workdir: str | None = None,
        process_id: int = 0,
        timeout: float | None = None,
        env: dict | None = None,
    ):
        """Unpack the bundle into ``workdir`` and run one rank in place
        (the single-process smoke path). ``env``: variables added to this
        process's environment for the rank. Returns the CompletedProcess;
        raises subprocess.TimeoutExpired past ``timeout`` seconds (the
        rank is killed)."""
        workdir = workdir or tempfile.mkdtemp(prefix="dkt_job_")
        bundle = self.package(os.path.join(workdir, "bundle.tar.gz"))
        self._unpack(bundle, workdir)
        return subprocess.run(
            ["sh", "run.sh", str(process_id)],
            cwd=workdir,
            capture_output=True,
            text=True,
            timeout=timeout,
            env=None if env is None else {**os.environ, **env},
        )

    def run_local_all(self, workdir: str | None = None,
                      timeout: float | None = RANK_TIMEOUT):
        """Every rank of the job on this host at once, each in its own
        directory under ``workdir`` (default: a temporary one, removed
        after). The ranks share the host's cores: each gets
        ``OMP_NUM_THREADS`` = cores / ranks unless the caller set it (a
        CPU rank spinning on every core starves its peers' collectives).
        The first rank to exit non-zero, or ``timeout`` seconds, ends the
        launch: every rank still running is killed (its peers would
        otherwise wait in a collective for the group's timeout). The
        ranks stay in this process's group, so a signal to the group (a
        terminal's Ctrl-C, a ``killpg`` of the launcher) reaches them too.
        Returns the CompletedProcesses in rank order; raises
        ``RuntimeError`` with a failed rank's output tail, or
        ``subprocess.TimeoutExpired``."""
        if workdir is None:
            with tempfile.TemporaryDirectory(prefix="dkt_job_") as tmp:
                return self.run_local_all(tmp, timeout)
        bundle = self.package(os.path.join(workdir, "bundle.tar.gz"))
        threads = max(1, (os.cpu_count() or 1) // self.num_hosts)
        env = {**os.environ, "OMP_NUM_THREADS": os.environ.get(
            "OMP_NUM_THREADS", str(threads))}
        deadline = None if timeout is None else time.monotonic() + timeout
        procs, logs, failed = [], [], None
        try:
            for i in range(self.num_hosts):
                rank_dir = self._unpack(bundle,
                                        os.path.join(workdir, f"rank{i}"))
                logs.append((os.path.join(rank_dir, "stdout.txt"),
                             os.path.join(rank_dir, "stderr.txt")))
                with open(logs[-1][0], "w") as out, \
                        open(logs[-1][1], "w") as err:
                    procs.append(subprocess.Popen(
                        ["sh", "run.sh", str(i)], cwd=rank_dir, stdout=out,
                        stderr=err, env=env))
            while True:
                codes = [p.poll() for p in procs]
                # the first rank to fail, before its peers are killed
                failed = next((i for i, c in enumerate(codes) if c), None)
                if failed is not None or None not in codes:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired(
                        f"{self.num_hosts} ranks of {self.script}", timeout)
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        done = []
        for p, (out, err) in zip(procs, logs):
            with open(out) as f_out, open(err) as f_err:
                done.append(subprocess.CompletedProcess(
                    p.args, p.returncode, f_out.read(), f_err.read()))
        if failed is not None:
            proc = done[failed]
            raise RuntimeError(
                f"rank {failed} of {self.num_hosts} exited "
                f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                f"{proc.stderr[-3000:]}"
            )
        return done


def local_address() -> str:
    """``127.0.0.1:<a free port>``: a coordinator address for ranks that
    all run on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_local_ranks(script: str, num_ranks: int, script_args=(),
                    path_flags=(), label: str = "sync",
                    device: str | None = None,
                    timeout: float | None = RANK_TIMEOUT) -> None:
    """``script`` as ``num_ranks`` gloo rank processes on this host (gloo
    takes CPU ranks and ranks that share a card), through
    ``Job.run_local_all``: prints ``"<label>: N rank processes over gloo
    on the CPU"`` (or ``the card``, ``device`` being the ranks'), then
    rank 0's standard output. Each rank runs in a directory of its own,
    so the value after each flag of ``path_flags`` in ``script_args`` is
    made absolute first."""
    print(f"{label}: {num_ranks} rank processes over gloo on "
          f"{'the CPU' if device == 'cpu' else 'the card'}", flush=True)
    args = [str(a) for a in script_args]
    for i, a in enumerate(args[:-1]):
        if a in path_flags:
            args[i + 1] = os.path.abspath(args[i + 1])
    job = Job(script, num_hosts=num_ranks,
              coordinator_address=local_address(), script_args=args,
              backend="gloo")
    print(job.run_local_all(timeout=timeout)[0].stdout, end="", flush=True)
