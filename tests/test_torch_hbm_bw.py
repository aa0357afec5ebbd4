"""The port's bandwidth probes against the Pallas kernels of tools/hbm_bw.py.

The JAX probes return only a GB/s figure and build their kernel inside, so
each test runs the JAX probe once at a tiny size with `pl.pallas_call`
spied on (the spy keeps the callable each call returns), then calls that
callable eagerly, in interpret mode on the CPU, on a seed and random int8
data from numpy, and holds the port's plain version (what its wrapper runs
for a CPU tensor) equal to it: the outputs are integers in fp32, so the
tolerance is exact. Random data matters: the probes' own `ones` input
would hide an indexing fault. The probes' size formulas and byte counts are
held equal to the JAX file's through a clock that ticks 0.5 s per reading
(each probe then returns bytes / 0.5 s).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hip_llama_tpu_torch.ops import hbm_bw as H
from hip_llama_tpu_torch.tools import hbm_bw as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jhbm():
    spec = importlib.util.spec_from_file_location("_jax_tools_hbm_bw",
                                                  os.path.join(REPO, "tools", "hbm_bw.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """time.perf_counter for both probe modules: 0.5 s per reading."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.5
        return self.t


@pytest.fixture
def spy(monkeypatch, jhbm):
    """The callables and the grid_spec of every pallas_call the JAX probes
    make; both modules' clocks replaced."""
    kept = []
    real = jhbm.pl.pallas_call

    def pallas_call(kernel, **kw):
        call = real(kernel, **kw)
        kept.append((call, kw["grid_spec"]))
        return call

    monkeypatch.setattr(jhbm.pl, "pallas_call", pallas_call)
    monkeypatch.setattr(jhbm, "time", _Clock())
    monkeypatch.setattr(T, "time", _Clock())
    return kept


def _x(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("seed", [5, -3])
@pytest.mark.parametrize("streams", [1, 2, 4])
def test_dma_read_matches_the_pallas_kernel(jhbm, spy, streams, seed):
    jhbm.dma_probe(gb=2 ** -14, reps=2, streams=streams, block_kib=8)
    call, _ = spy[0]
    n = T.dma_sizes(2 ** -14, streams, 8)["n"]
    x = _x(np.random.default_rng(seed + 10 * streams), (n, 1024))
    sd = np.array([seed], np.int32)
    want = np.asarray(call(jnp.asarray(sd), *([jnp.asarray(x)] * streams)))
    got = H.dma_read(torch.from_numpy(sd), torch.from_numpy(x), 8, streams)
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("streams", [1, 2, 4])
def test_dma_copy_matches_the_pallas_kernel(jhbm, spy, streams):
    jhbm.dma_probe(gb=2 ** -14, copy=True, reps=2, streams=streams, block_kib=8)
    call, _ = spy[0]
    n = T.dma_sizes(2 ** -14, streams, 8)["n"]
    x = _x(np.random.default_rng(streams), (n, 1024))
    want = call(jnp.asarray(np.array([5], np.int32)), *([jnp.asarray(x)] * streams))
    got = H.dma_copy(torch.from_numpy(x), 8, streams)
    assert len(got) == len(want) == streams
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bn", [128, 256])
def test_wshape_read_matches_the_pallas_kernel(jhbm, spy, bn):
    jhbm.wshape_probe(gb=2 ** -12, reps=2, bk=64, bn=bn)
    call, _ = spy[0]
    n_cols = T.wshape_sizes(2 ** -12, 64, bn)["n_cols"]
    x = _x(np.random.default_rng(bn), (64, n_cols))
    sd = np.array([5], np.int32)
    want = np.asarray(call(jnp.asarray(sd), jnp.asarray(x)))
    got = H.wshape_read(torch.from_numpy(sd), torch.from_numpy(x), bn)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth", [2, 3])
def test_deep_read_matches_the_pallas_kernel(jhbm, spy, depth):
    jhbm.deep_probe(gb=2 ** -14, reps=2, depth=depth, block_kib=8)
    call, _ = spy[0]
    n = T.deep_sizes(2 ** -14, 8)["n"]
    x = _x(np.random.default_rng(depth), (n, 1024))
    sd = np.array([3], np.int32)
    want = np.asarray(call(jnp.asarray(sd), jnp.asarray(x)))
    got = H.deep_read(torch.from_numpy(sd), torch.from_numpy(x), 8, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    # the corner of block (n_blocks - 1) // depth * depth: of 8 blocks,
    # block 6 at depth 2 and at depth 3
    b = H.deep_target(n // 8, depth)
    assert b == 6
    np.testing.assert_array_equal(want, x[b * 8:b * 8 + 8, :128].astype(np.float32) + 3)


@pytest.mark.parametrize("gb,streams,block_kib", [(2 ** -14, 2, 8), (2 ** -13, 4, 8),
                                                   (3e-5, 1, 16), (2 ** -12, 8, 8)])
@pytest.mark.parametrize("copy", [False, True])
def test_dma_sizes_and_bytes_match(jhbm, spy, gb, streams, block_kib, copy):
    want_gbs = jhbm.dma_probe(gb=gb, copy=copy, reps=2, streams=streams, block_kib=block_kib)
    sz = T.dma_sizes(gb, streams, block_kib)
    assert spy[0][1].grid == (sz["per"],)
    assert sz["per"] * streams == sz["n_blocks"] and sz["n"] == sz["n_blocks"] * block_kib
    # the clock makes every timing 0.5 s: GB/s = bytes / 0.5e9
    assert want_gbs * 0.5e9 == 2 * sz["n"] * 1024 * (2 if copy else 1)
    assert T.dma_probe(gb=gb, copy=copy, reps=2, streams=streams, block_kib=block_kib,
                       device="cpu") == want_gbs


@pytest.mark.parametrize("gb,bk,bn", [(2 ** -12, 64, 128), (2 ** -11, 32, 256)])
def test_wshape_sizes_and_bytes_match(jhbm, spy, gb, bk, bn):
    want_gbs = jhbm.wshape_probe(gb=gb, reps=2, bk=bk, bn=bn)
    sz = T.wshape_sizes(gb, bk, bn)
    assert spy[0][1].grid == (sz["n_blocks"],)
    assert want_gbs * 0.5e9 == 2 * bk * sz["n_cols"]
    assert T.wshape_probe(gb=gb, reps=2, bk=bk, bn=bn, device="cpu") == want_gbs


@pytest.mark.parametrize("gb,depth,block_kib", [(2 ** -14, 2, 8), (3e-5, 4, 8)])
def test_deep_sizes_and_bytes_match(jhbm, spy, gb, depth, block_kib):
    want_gbs = jhbm.deep_probe(gb=gb, reps=2, depth=depth, block_kib=block_kib)
    sz = T.deep_sizes(gb, block_kib)
    assert sz["n_blocks"] * block_kib == sz["n"]
    assert want_gbs * 0.5e9 == 2 * sz["n"] * 1024
    assert T.deep_probe(gb=gb, reps=2, depth=depth, block_kib=block_kib,
                        device="cpu") == want_gbs


def test_xreduce_bytes_match(jhbm, spy):
    want_gbs = jhbm.xreduce_probe(gb=2 ** -14, reps=2)
    assert want_gbs * 0.5e9 == 2 * 4096 * T.xreduce_cols(2 ** -14)
    assert T.xreduce_probe(gb=2 ** -14, reps=2, device="cpu") == want_gbs


def test_ladder_lines_grade_against_the_h100_spec(capsys):
    T.main(["--mode", "dma", "--gb", "0.0002", "--block-kib", "8", "--device", "cpu"])
    T.main(["--mode", "dmadeep", "--gb", "0.0002", "--block-kib", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out] == [
        "  streams=1", "  streams=2", "  streams=4", "  streams=8", "dma_dma",
        "use as the port bench's achievable denominator",
        "  depth=2", "  depth=4", "  depth=8", "  depth=16", "dma_deep"]
    assert "of the 3350 GB/s spec sheet" in out[4]
    assert "HIPLLAMA_ACHIEVABLE_BW=" in out[-1]
    assert not any("819 GB/s" in ln or "819.0" in ln for ln in out)


def test_wrappers_guard_exactness_and_shapes():
    """The fp32 corner sums stay exact below 2^24: the CUDA wrappers refuse
    more blocks than leave room for a seed below 2^23; the plain versions
    refuse blocks that do not hold a corner."""
    H._exact(H.EXACT_BLOCKS, "t")
    with pytest.raises(ValueError, match="2\\^23"):
        H._exact(H.EXACT_BLOCKS + 1, "t")
    x = torch.zeros((64, 1024), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 8"):
        H.dma_read(torch.tensor([0], dtype=torch.int32), x, 4, 1)
    with pytest.raises(ValueError, match="seed"):
        H.dma_read(torch.tensor([0]), x, 8, 1)
    assert H.stream_piece(4096 * 1024) == 32 * 1024 and H.stream_piece(24 * 1024) == 8 * 1024
    assert H.wshape_rows(4096, 512) == 64 and H.wshape_rows(1000, 1024) == 8
    assert H.deep_piece(8) == 16 * 1024 and H.deep_piece(16) == 12 * 1024
