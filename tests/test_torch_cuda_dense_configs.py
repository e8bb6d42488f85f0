"""The three remaining dense configs on the card: the GEMM shapes their paths
bring (ChatGLM3-6B, Command R+ 104B, Qwen1.5-110B at full width) against
the plain version, and a warm start of ChatGLM3-6B from the on-disk program
store in a second process.  Every test here needs an NVIDIA card and skips
without one; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_dense_configs.py``.

GEMM tolerances are ``tests/test_torch_cuda_kernels.py``'s: fp32 atol/rtol
1e-4 (plain FMAs in another summation order; the weights are scaled by
1/sqrt(k), so outputs stay of order 1), bf16 atol 0.125, rtol 2e-2 (one
bf16 rounding of values of order 10).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.fused_matmul import ops, ref

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _tol(dt):
    return (1e-4, 1e-4) if dt == torch.float32 else (0.125, 2e-2)


def _shapes():
    """(arch, name, k, n, bias) of every projection of the three configs:
    fused QKV (with its bias epilogue where the config has one), the
    output projection, fused gate|up, down and the head."""
    out = []
    for arch in ("chatglm3_6b", "command_r_plus_104b", "qwen1_5_110b"):
        c = get_config(arch)
        d, hd = c.d_model, c.hd
        out += [(arch, "qkv", d, (c.n_heads + 2 * c.n_kv_heads) * hd,
                 c.qkv_bias),
                (arch, "wo", c.n_heads * hd, d, False),
                (arch, "gate_up", d, 2 * c.d_ff, False),
                (arch, "down", c.d_ff, d, False),
                (arch, "head", d, c.vocab, False)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 300])
@pytest.mark.parametrize("arch,name,k,n,bias", _shapes())
def test_dense_config_gemm_shapes_match_plain(cuda, dt, m, arch, name, k, n,
                                              bias):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    epi = []
    if bias:
        epi = [("add", [torch.randn(n, generator=g, device=cuda).to(dt)],
                {"dtype": str(dt).split(".")[-1]})]
    before = ops.launches
    y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)
    del x, w, y, want
    torch.cuda.empty_cache()


_WARM_BODY = """
import dataclasses, hashlib, json, sys
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.models.base import get_model
from repro_torch.serve import Request, ServeConfig, ServingEngine
cfg = dataclasses.replace(get_config("chatglm3_6b"), n_layers=2)
model = get_model(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
rng = np.random.default_rng(0)
prefix = rng.integers(1, cfg.vocab, 128).astype(np.int32)
reqs = [Request(i, np.concatenate([prefix, rng.integers(1, cfg.vocab, n)
                                   .astype(np.int32)]), max_new=8)
        for i, n in enumerate((20, 44, 7, 31))]
eng = ServingEngine(model, batch=2, max_len=512, device="cuda",
                    cfg=ServeConfig(target="gpu", program_cache_dir=sys.argv[1]))
out = eng.run(reqs)
st = eng.last_stats
print("STATS::" + json.dumps({
    "compiled": st["compiled_programs"], "hits": st["l2_hits"],
    "writes": st["l2_writes"], "quarantined": st["l2_quarantined"],
    "captures": st["graph_captures"],
    "tokens": [list(map(int, r.out)) for r in out]}))
"""


def _warm_run(store: str, cwd) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _WARM_BODY, store],
                         cwd=str(cwd), env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("STATS::")][-1]
    return json.loads(line[len("STATS::"):])


@pytest.mark.cuda
def test_chatglm3_warm_process_compiles_nothing(cuda, tmp_path):
    """ChatGLM3-6B at full width and 2 layers served in two processes on
    one store: the second compiles no region program, hits every one the
    first compiled, captures as many CUDA graphs and serves the same
    tokens bitwise."""
    store = str(tmp_path / "store")
    cold = _warm_run(store, tmp_path)
    warm = _warm_run(store, tmp_path)
    assert cold["compiled"] > 0 and cold["writes"] == cold["compiled"]
    assert warm["compiled"] == 0 and warm["hits"] == cold["compiled"]
    assert warm["quarantined"] == 0
    assert warm["captures"] == cold["captures"]
    assert warm["tokens"] == cold["tokens"]
