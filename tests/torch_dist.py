"""Test-only helpers for the port's data-parallel tests.

``run_ranks(fn, sizes, tmp_path, *args)`` runs ``fn(groups, *args)`` on
``prod(sizes)`` gloo ranks on the CPU (a mesh over ``axes=``, by default
the DP axes of ``sizes``), each a spawned process of its own
that joins through a FileStore under ``tmp_path`` (so parallel test
workers never share a rendezvous), and returns each rank's result (a
torch-picklable object).  A rank that raises fails the test with its
traceback, and past ``timeout`` seconds every rank is killed and the
test fails, so a hung collective cannot stall the suite.  ``fn`` must be
a module-level function of a module that imports no jax.

``run_reference(body, ndev, tmp_path)`` runs ``body`` (Python source)
in a fresh interpreter that sees ``ndev`` forced host CPU devices, as
the reference's ``tests/test_distributed.py::run_devprog`` does (the
calling process keeps one JAX device); ``body`` writes its results with
``save(obj)`` (a pickle of numpy trees), which this returns;
``start_reference`` starts it and returns a function that waits for it.
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import torch

from repro_torch.dist import (RankFailed, close_dp, init_dp, rank_device,
                              spawn)

ROOT = Path(__file__).resolve().parents[1]


def _entry(rank, fn, sizes, store, out_dir, args, axes=None):
    torch.set_num_threads(1)
    groups = init_dp(rank, sizes, rank_device("cpu", rank), store, axes)
    try:
        res = fn(groups, *args)
    finally:
        close_dp()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(fn, sizes, tmp_path, *args, timeout=120.0, axes=None):
    sizes = tuple(sizes)
    world = 1
    for s in sizes:
        world *= s
    d = Path(tempfile.mkdtemp(prefix=f"{fn.__name__}_", dir=tmp_path))
    try:
        spawn(_entry, world, (fn, sizes, str(d / "store"), str(d), args,
                              axes), timeout=timeout)
    except (RankFailed, TimeoutError) as e:
        raise AssertionError(f"{world} gloo ranks of {fn.__name__}: "
                             f"{e}") from None
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


_PRELUDE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={ndev}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {tests!r})

def save(obj):
    with open({out!r}, "wb") as f:
        pickle.dump(obj, f)
"""


def start_reference(body: str, ndev: int, tmp_path, timeout=560):
    """Start ``body`` in its interpreter; returns a function that waits for
    it and returns what it saved (the caller works meanwhile)."""
    out = Path(tmp_path) / f"reference_{ndev}.pkl"
    prog = _PRELUDE.format(ndev=ndev, tests=str(ROOT / "tests"),
                           out=str(out)) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def wait():
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, \
            f"STDOUT:{stdout[-3000:]}\nSTDERR:{stderr[-6000:]}"
        with open(out, "rb") as f:
            return pickle.load(f)

    return wait


def run_reference(body: str, ndev: int, tmp_path, timeout=560):
    return start_reference(body, ndev, tmp_path, timeout)()
