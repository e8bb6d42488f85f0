"""Rank-process harness for mesh code, shared by the tests and
``chip_smoke.py``.

A mesh is one process per position (explicit SPMD).  ``run_ranks`` starts
``world`` copies of a script body, each joined to one process group over
a ``FileStore`` in a fresh directory, and collects the ``result`` dict
each rank fills, printed behind a ``RESULT::`` marker.  A rank that fails
or outlives ``timeout`` fails the run; every process is stopped before
it returns.

Pre-set in each rank: ``os``, ``json``, ``dataclasses``, ``np``,
``torch``, ``dist`` (``torch.distributed``), ``rank``, ``world``,
``device`` (``cuda`` or ``cpu``), ``backend`` and ``result``; the repo's
``src`` is on ``PYTHONPATH``, torch runs one CPU thread, and a rank runs
at a lower priority (nice 10) than the process that started it, so rank
runs in a test suite do not starve its other workers.  The body imports
no JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

#: the repo's src dir (this file lives at src/repro_torch/testing.py)
SRC_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PREAMBLE = """
import os, json, dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
os.nice(10)       # below the processes that started the ranks
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, device = sys.argv[3], sys.argv[4]
from repro_torch.launch.mesh import choose_backend, init_world
backend = sys.argv[5] if sys.argv[5] != "auto" else choose_backend(device,
                                                                   world)
if rank == 0:
    print(f"rank backend: {backend} ({world} ranks on {device})",
          file=sys.stderr)
init_world(rank, world, store, backend)
result = {}
"""

_EPILOGUE = """
print("RESULT::" + json.dumps(result))
sys.stdout.flush()
dist.destroy_process_group()
"""


def run_ranks(body: str, world: int, device: str = "cpu",
              timeout: float = 60.0, env: dict | None = None,
              backend: str = "auto") -> list[dict]:
    """Run ``body`` in ``world`` rank processes and return each rank's
    ``result`` dict, in rank order.  ``backend``: ``auto`` (the choice of
    ``launch.mesh.choose_backend``) or a backend named explicitly."""
    script = _PREAMBLE + textwrap.dedent(body) + _EPILOGUE
    tmp = tempfile.mkdtemp(prefix="ranks-")
    path = os.path.join(tmp, "rank_body.py")
    with open(path, "w") as f:
        f.write(script)
    store = os.path.join(tmp, "store")
    penv = dict(os.environ, **(env or {}))
    penv["PYTHONPATH"] = SRC_DIR + (os.pathsep + penv["PYTHONPATH"]
                                    if penv.get("PYTHONPATH") else "")
    penv.setdefault("OMP_NUM_THREADS", "1")
    logs = [(open(os.path.join(tmp, f"rank{r}.out"), "w+"),
             open(os.path.join(tmp, f"rank{r}.err"), "w+"))
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, path, str(r), str(world),
                               store, device, backend], env=penv,
                              stdout=out, stderr=err, text=True)
             for r, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        # until all exit, one fails (its peers would wait on it in a
        # collective) or the time is up
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"rank processes outlived {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        # the first to fail, not a peer killed after it
        r = next((r for r in bad if procs[r].returncode > 0), bad[0])
        raise AssertionError(f"rank {r} exited {procs[r].returncode}:\n"
                             f"{texts[r][1][-4000:]}")
    results = []
    for r, (out, _) in enumerate(texts):
        line = next((ln for ln in out.splitlines()
                     if ln.startswith("RESULT::")), None)
        if line is None:
            raise AssertionError(f"rank {r} printed no RESULT:: line:\n"
                                 f"{out[-2000:]}")
        results.append(json.loads(line[len("RESULT::"):]))
    return results
