"""The port's data pipeline (``repro_torch.data``) against the JAX
package's ``repro.data``: the same numpy code, so every batch must be the
same bytes, across seeds, steps and shards; the prefetcher, the file
source on a temporary corpus, and ``to_device``."""
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro_torch import data


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_hosts,host", [(1, 0), (2, 0), (2, 1)])
def test_batches_equal_the_reference_bitwise(seed, n_hosts, host):
    kw = dict(seq_len=32, global_batch=4, vocab=1000, seed=seed)
    got = data.TokenPipeline(data.DataConfig(**kw), host, n_hosts)
    want = jdata.TokenPipeline(jdata.DataConfig(**kw), host, n_hosts)
    for step in (0, 5, 17):
        a, b = got.batch_at(step), want.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_pipeline_deterministic_and_shifted():
    cfg = data.DataConfig(seq_len=32, global_batch=4, vocab=1000, seed=7)
    p1, p2 = data.TokenPipeline(cfg), data.TokenPipeline(cfg)
    for s in (0, 5, 17):
        np.testing.assert_array_equal(p1.batch_at(s)["tokens"],
                                      p2.batch_at(s)["tokens"])
    raw = p1.src.batch(0, 0, 4, 32)
    np.testing.assert_array_equal(p1.batch_at(0)["labels"], raw[:, 1:])


def test_prefetcher_matches_direct():
    pipe = data.TokenPipeline(data.DataConfig(seq_len=16, global_batch=2,
                                              vocab=100, seed=5))
    pf = data.Prefetcher(pipe, start_step=3)
    try:
        for expect in (3, 4, 5):
            s, batch = pf.next()
            assert s == expect
            np.testing.assert_array_equal(batch["tokens"],
                                          pipe.batch_at(expect)["tokens"])
    finally:
        pf.close()


def test_file_source_matches_the_reference(tmp_path):
    toks = (np.arange(10_000) % 251).astype(np.uint16)
    path = tmp_path / "corpus.bin"
    toks.tofile(path)
    kw = dict(seq_len=32, global_batch=4, vocab=251, seed=1, source="file",
              path=str(path))
    b = data.TokenPipeline(data.DataConfig(**kw)).batch_at(3)
    want = jdata.TokenPipeline(jdata.DataConfig(**kw)).batch_at(3)
    assert b["tokens"].shape == (4, 32) and b["tokens"].max() < 251
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b[k], want[k])


def test_to_device_makes_int32_tensors():
    batch = data.TokenPipeline(data.DataConfig(seq_len=8, global_batch=2,
                                               vocab=50)).batch_at(0)
    batch["mask"] = np.ones((2, 8), np.float32)
    out = data.to_device(batch, "cpu")
    assert out["tokens"].dtype == out["labels"].dtype == torch.int32
    assert out["mask"].dtype == torch.float32
    np.testing.assert_array_equal(out["tokens"].numpy(), batch["tokens"])
