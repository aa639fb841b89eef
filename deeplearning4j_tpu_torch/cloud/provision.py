"""Cluster provisioning over pluggable command transports.

The port of deeplearning4j_tpu/cloud/provision.py. One counterpart:
`ClusterSpec.launch_env` keeps the reference's three DL4J_TPU_* variables
and also sets torch.distributed's RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT from the same spec (the process id, the number of hosts, the
first host and the coordinator port), which the port's
`parallel/main.py` reads to join a process group. The text below is the
reference's.

TPU-native equivalent of reference deeplearning4j-aws's cluster setup
(aws/ec2/provision/ClusterSetup.java + HostProvisioner.java — create EC2
boxes, then run setup commands / copy files over SSH). The TPU analogue
provisions worker hosts for a multi-host jax.distributed job:

- CommandRunner SPI: LocalCommandRunner (subprocess; used by tests and for
  localhost setups) and SSHCommandRunner (shells out to the system `ssh`/
  `scp`, the HostProvisioner role — no paramiko in this image).
- ClusterSpec + ClusterProvisioner: run a setup script on every host and
  emit per-host launch commands carrying the jax.distributed coordinator
  address / process ids (the Spark-master/worker config the reference
  writes becomes coordinator env vars).

Actual accelerator-VM creation (the Ec2BoxCreator role) is cloud-CLI
specific and intentionally out of scope: `create_instances_command` renders
the gcloud command a TPU operator runs, rather than wrapping half of a
cloud SDK that isn't installed here.
"""
from __future__ import annotations

import shlex
import subprocess


class CommandRunner:
    def run(self, command, timeout=120):
        """Returns (returncode, stdout+stderr)."""
        raise NotImplementedError

    def copy_to(self, local_path, remote_path):
        raise NotImplementedError


class LocalCommandRunner(CommandRunner):
    """reference test pattern: provisioning logic exercised without real
    boxes (the HostProvisioner unit seam)."""

    def run(self, command, timeout=120):
        p = subprocess.run(command, shell=True, capture_output=True,
                           text=True, timeout=timeout)
        return p.returncode, p.stdout + p.stderr

    def copy_to(self, local_path, remote_path):
        import shutil
        shutil.copy(local_path, remote_path)


class SSHCommandRunner(CommandRunner):
    """reference: aws/ec2/provision/HostProvisioner.java (jsch SSH there;
    the system ssh/scp binaries here)."""

    def __init__(self, host, user=None, key_file=None, ssh_options=()):
        self.target = f"{user}@{host}" if user else host
        self.key_args = ["-i", key_file] if key_file else []
        self.extra = list(ssh_options)

    def run(self, command, timeout=120):
        cmd = (["ssh"] + self.key_args + self.extra
               + [self.target, command])
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        return p.returncode, p.stdout + p.stderr

    def copy_to(self, local_path, remote_path):
        cmd = (["scp"] + self.key_args + self.extra
               + [local_path, f"{self.target}:{remote_path}"])
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"scp failed: {p.stdout}{p.stderr}")


class ClusterSpec:
    """reference: the Ec2BoxCreator parameters, reshaped for TPU hosts."""

    def __init__(self, hosts, coordinator_port=8476, setup_commands=(),
                 env=None):
        self.hosts = list(hosts)
        self.coordinator_port = int(coordinator_port)
        self.setup_commands = list(setup_commands)
        self.env = dict(env or {})

    @property
    def coordinator_address(self):
        return f"{self.hosts[0]}:{self.coordinator_port}"

    def launch_env(self, process_id):
        """Per-host environment for a jax.distributed worker (what the
        reference's Spark master/worker config files carried)."""
        env = dict(self.env)
        env.update({
            "DL4J_TPU_COORDINATOR": self.coordinator_address,
            "DL4J_TPU_NUM_PROCESSES": str(len(self.hosts)),
            "DL4J_TPU_PROCESS_ID": str(process_id),
            # torch.distributed's launch variables (parallel/main.py)
            "MASTER_ADDR": self.hosts[0],
            "MASTER_PORT": str(self.coordinator_port),
            "RANK": str(process_id),
            "WORLD_SIZE": str(len(self.hosts)),
        })
        return env


class ClusterProvisioner:
    """reference: aws/ec2/provision/ClusterSetup.java — provision every
    host, then hand back launch commands."""

    def __init__(self, spec, runner_factory=None):
        self.spec = spec
        self.runner_factory = runner_factory or (
            lambda host: SSHCommandRunner(host))

    def provision(self):
        """Run setup_commands on every host; returns {host: [(rc, out)]}.
        Raises on the first failing command (a half-provisioned cluster is
        an error, matching the reference's fail-fast provisioning)."""
        results = {}
        for host in self.spec.hosts:
            runner = self.runner_factory(host)
            results[host] = []
            for cmd in self.spec.setup_commands:
                rc, out = runner.run(cmd)
                results[host].append((rc, out))
                if rc != 0:
                    raise RuntimeError(
                        f"provisioning {host} failed at {cmd!r}: {out}")
        return results

    def launch_commands(self, worker_command):
        """Per-host shell commands that start `worker_command` with the
        jax.distributed coordinator env applied."""
        out = []
        for pid, host in enumerate(self.spec.hosts):
            env = self.spec.launch_env(pid)
            prefix = " ".join(f"{k}={shlex.quote(v)}"
                              for k, v in sorted(env.items()))
            out.append((host, f"env {prefix} {worker_command}"))
        return out


def create_instances_command(name_prefix, zone, accelerator_type="v5e-8",
                             count=1, image_family="tpu-ubuntu2204-base"):
    """Render the gcloud command that creates TPU VM(s) — the Ec2BoxCreator
    role, rendered instead of executed (no cloud SDK/credentials here)."""
    cmds = []
    for i in range(count):
        cmds.append(
            f"gcloud compute tpus tpu-vm create {name_prefix}-{i} "
            f"--zone={zone} --accelerator-type={accelerator_type} "
            f"--version={image_family}")
    return cmds
