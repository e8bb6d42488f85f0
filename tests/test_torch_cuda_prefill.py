"""Suffix prefill equals full prefill on the card, bitwise.

The slot path prefills a prompt whose leading pages are already resident
(a shared prefix) by running only its suffix (``prefill_into_slot`` with
``start > 0``).  The port's guarantee is that this gives the logits and
the K/V pages of a full prefill of the same prompt bit for bit, which
holds only if no product on the path reduces in an order that depends on
how many rows run (the GEMM kernel's plan never reads m; the masked
attention composite runs its products as fp32 ``torch.einsum``).

The sweep runs qwen2.5-3b's layer widths (d_model 2048, 16 / 2 heads of
128, d_ff 11008, its vocabulary) cut to 2 layers, bf16 compute, random
weights from seed 0, pages of 16 over max_len 128: for every start at a
page boundary and every suffix length up to the end of the slot, the
prefix prefilled alone and then the suffix against one full prefill.  The
prompt buckets are the engine's (``bucket_pow2``, clamped to max_len).
Needs an NVIDIA card; run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_prefill.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.models.base import get_model
from repro_torch.models.layers import bucket_pow2
from repro_torch.serve import ServeConfig

MAX_LEN, PAGE = 128, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _prefill(model, sp, cache, toks, lo: int, hi: int):
    """Rows ``[lo, hi)`` of ``toks`` into slot 0 as the engine pads them;
    the prompt is ``toks[:hi]``."""
    n = hi - lo
    padded = np.zeros((1, min(bucket_pow2(n), MAX_LEN)), np.int32)
    padded[0, :n] = toks[lo:hi]
    return model.prefill_into_slot(sp, torch.as_tensor(padded,
                                                       device="cuda"),
                                   cache, 0, hi, start=lo)


def _rows(cache, n: int) -> list:
    """Slot 0's K and V of positions ``[0, n)``, per layer."""
    row = cache["ptab"][0].long()
    return [pool[row].reshape(-1, *pool.shape[2:])[:n]
            for pool in cache["k"] + cache["v"]]


def _clone(cache) -> dict:
    return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
            for k, v in cache.items()}


@pytest.mark.cuda
def test_suffix_prefill_equals_full_prefill_bitwise(cuda):
    cfg = dataclasses.replace(get_config("qwen2_5_3b"), n_layers=2)
    model = get_model(cfg, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(0))
    toks = np.random.default_rng(0).integers(1, cfg.vocab, MAX_LEN)
    toks = toks.astype(np.int32)
    failing = []
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        sp = model.compute_params()
        full = {}
        for plen in range(PAGE + 1, MAX_LEN + 1):
            cache = model.init_slot_cache(1, MAX_LEN, PAGE)
            lg, cache = _prefill(model, sp, cache, toks, 0, plen)
            full[plen] = (lg, _rows(cache, plen))
        for start in range(PAGE, MAX_LEN, PAGE):
            base = model.init_slot_cache(1, MAX_LEN, PAGE)
            _, base = _prefill(model, sp, base, toks, 0, start)
            for n in range(1, MAX_LEN - start + 1):
                lg, cache = _prefill(model, sp, _clone(base), toks, start,
                                     start + n)
                want_lg, want_rows = full[start + n]
                same = torch.equal(lg, want_lg) and all(
                    torch.equal(a, b)
                    for a, b in zip(_rows(cache, start + n), want_rows))
                if not same:
                    failing.append((start, n))
    assert not failing, f"(start, suffix length) not bitwise: {failing}"
