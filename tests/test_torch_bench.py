"""The port bench (hip_llama_tpu_torch/bench.py) against the JAX bench.py:
the same flags, fields and metric names, the same speed-of-light inputs
(live KV fraction, parameter bytes of each layout), and every mode run end
to end on the CPU at a tiny config (`--device cpu`, the plain versions):
one JSON line with the expected metric. The decode chain that the card
replays as one CUDA graph is held to a step-by-step loop's tokens.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import pytest
import torch

from hip_llama_tpu.config import ModelConfig as JaxModelConfig
from hip_llama_tpu_torch import bench
from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models.llama import init_kv_cache, make_decode_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=4, vocab_size=256,
            seq_len=128)


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("_jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(monkeypatch, jbench):
    """A tiny config named "tiny" in both benches' CONFIGS."""
    monkeypatch.setitem(bench.CONFIGS, "tiny", ModelConfig(**TINY))
    monkeypatch.setitem(jbench.CONFIGS, "tiny", JaxModelConfig(**TINY))
    return "tiny"


ARGVS = [
    [], ["--mode", "ttft"], ["--mode", "serve"], ["--quant", "none"], ["--quant", "q4"],
    ["--kv", "bf16"], ["--quant", "none", "--kv", "bf16", "--dtype", "float32"],
    ["--mode", "serve", "--paged"], ["--mode", "serve", "--prefix-cache"],
    ["--mode", "serve", "--paged", "--prefix-cache", "--quant", "none", "--kv", "bf16"],
    ["--quick"], ["--quick", "--steps", "32"], ["--batch", "4"], ["--prompt-len", "64"],
    ["--mode", "ttft", "--prompt-len", "64", "--batch", "4", "--kv", "bf16"],
    ["--mode", "serve", "--quant", "q4", "--prompts", "3", "--window", "256"],
    ["--loop", "host", "--warmup", "1"], ["--layout", "stacked"], ["--mode", "stream"],
    ["--mode", "serve", "--chunk", "4", "--spec", "2"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_flags_and_metric_names_match_the_jax_bench(jbench, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    want = jbench.parse_args()
    got = bench.parse_args(argv)
    fields = vars(got)
    assert fields.pop("device") == "cuda"
    assert fields == vars(want)
    assert bench.metric_name(got) == jbench.metric_name(want)


def test_live_kv_fraction_matches(jbench):
    for pos0 in (0, 1, 127, 128, 255, 256, 500, 1000):
        for steps in (1, 16, 128):
            for window in (512, 1024, 2048):
                if pos0 + steps <= window:
                    assert (bench.live_kv_fraction(pos0, steps, window)
                            == jbench.live_kv_fraction(pos0, steps, window))


@pytest.mark.parametrize("layout", ["dense", "q8", "q8 stacked", "q4"])
def test_param_bytes_match_the_jax_builders(jbench, tiny, layout):
    cfg, jcfg = bench.CONFIGS[tiny], jbench.CONFIGS[tiny]
    if layout == "dense":
        got = bench.rand_params_on_device(cfg, torch.bfloat16, "cpu")
        want = jbench.rand_params_on_device(jcfg, jnp.bfloat16)
    elif layout == "q8":
        got = bench.rand_qparams_unrolled_on_device(cfg, "cpu")
        want = jbench.rand_qparams_unrolled_on_device(jcfg)
    elif layout == "q8 stacked":
        got = bench.rand_qparams_stacked_fused_on_device(cfg, "cpu")
        want = jbench.rand_qparams_stacked_fused_on_device(jcfg)
        assert got.stacked
    else:
        got = bench.rand_q4params_unrolled_on_device(cfg, "cpu")
        want = jbench.rand_q4params_unrolled_on_device(jcfg)
        assert got.int4
    assert bench.param_bytes(got) == jbench.param_bytes(want)


def _codes_in_range(p) -> bool:
    q8 = bench.rand_qparams_unrolled_on_device(ModelConfig(**TINY), "cpu", seed=p)
    codes = torch.cat([q8.tok_emb_q.flatten()] + [w.q.flatten() for w in q8.wq])
    return int(codes.min()) == -127 and int(codes.max()) == 127


def test_random_params_follow_the_jax_distributions():
    """Q8 codes uniform in [-127, 127], scales fan_in^-0.5 / 127, and the
    same seed gives the same params."""
    assert _codes_in_range(0)
    cfg = ModelConfig(**TINY)
    a = bench.rand_qparams_unrolled_on_device(cfg, "cpu", seed=3)
    b = bench.rand_qparams_unrolled_on_device(cfg, "cpu", seed=3)
    assert torch.equal(a.wq[1].q, b.wq[1].q) and torch.equal(a.w2[0].q, b.w2[0].q)
    assert torch.allclose(a.w2[0].s, torch.full_like(a.w2[0].s, 256 ** -0.5 / 127.0))
    d = bench.rand_params_on_device(cfg, torch.float32, "cpu")
    assert abs(float(d.w1.std()) - 128 ** -0.5) < 0.01 and torch.equal(d.rms_att,
                                                                      torch.ones_like(d.rms_att))


def _run(capsys, argv) -> tuple[int, dict]:
    rc = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


CPU = ["--model", "tiny", "--device", "cpu", "--batch", "2", "--steps", "3"]
DECODE_KEYS = {"metric", "value", "unit", "vs_baseline", "estimator", "vs_clamped"}
RUNS = [
    ([], "decode_tok_per_s_per_chip_llama2_tiny_int8_kv8_b2", DECODE_KEYS),
    (["--quant", "none", "--kv", "bf16"], "decode_tok_per_s_per_chip_llama2_tiny_bfloat16_b2",
     DECODE_KEYS),
    (["--quant", "q4"], "decode_tok_per_s_per_chip_llama2_tiny_int4_kv8_b2", DECODE_KEYS),
    (["--quick"], "decode_tok_per_s_per_chip_llama2_tiny_int8_kv8_b2", DECODE_KEYS),
    (["--loop", "host"], "decode_tok_per_s_per_chip_llama2_tiny_int8_kv8_b2", DECODE_KEYS),
    (["--mode", "ttft", "--prompt-len", "40", "--window", "32"],
     "ttft_p50_ms_llama2_tiny_int8_kv8_b2_prompt31", {"metric", "value", "unit", "vs_baseline"}),
    (["--mode", "serve", "--prompt-len", "8", "--window", "24"],
     "serve_tok_per_s_llama2_tiny_int8_kv8_b2_prompt8", {"metric", "value", "unit", "vs_baseline"}),
    (["--mode", "serve", "--prompt-len", "8", "--window", "24", "--paged", "--prefix-cache"],
     "serve_tok_per_s_llama2_tiny_int8_kv8_b2_prompt8_paged_pfx",
     {"metric", "value", "unit", "vs_baseline"}),
    # multi-step chunks and prompt-lookup speculation: the JAX bench's
    # metric suffixes
    (["--mode", "serve", "--prompt-len", "8", "--window", "24", "--chunk", "4"],
     "serve_tok_per_s_llama2_tiny_int8_kv8_b2_prompt8_chunk4",
     {"metric", "value", "unit", "vs_baseline"}),
    (["--mode", "serve", "--prompt-len", "8", "--window", "24", "--spec", "2"],
     "serve_tok_per_s_llama2_tiny_int8_kv8_b2_prompt8_spec2",
     {"metric", "value", "unit", "vs_baseline"}),
]


@pytest.mark.parametrize("argv,metric,keys", RUNS, ids=lambda a: a if isinstance(a, str) else None)
def test_main_prints_one_result_line_on_the_cpu(tiny, capsys, monkeypatch, argv, metric, keys):
    monkeypatch.delenv("HIPLLAMA_ACHIEVABLE_BW", raising=False)
    if "--window" not in argv:
        argv = argv + ["--window", "64"]
    rc, line = _run(capsys, CPU + argv)
    assert rc == 0
    assert set(line) == keys
    assert line["metric"] == metric
    assert line["value"] > 0 and line["vs_baseline"] >= 0
    assert line["unit"] == ("ms" if metric.startswith("ttft") else "tok/s")


@pytest.mark.parametrize("env", ["3.0e12", "0"])
def test_achievable_bandwidth_comes_from_the_environment(tiny, capsys, monkeypatch, env):
    """HIPLLAMA_ACHIEVABLE_BW gives vs_achievable's denominator; 0 turns
    the field off (the CPU has no card to probe)."""
    monkeypatch.setenv("HIPLLAMA_ACHIEVABLE_BW", env)
    rc, line = _run(capsys, CPU + ["--window", "64"])
    assert rc == 0
    if env == "0":
        assert "vs_achievable" not in line
    else:
        assert line["vs_achievable"] == pytest.approx(line["vs_baseline"] * 3.35e12 / 3.0e12,
                                                      abs=1e-4)


@pytest.mark.parametrize("quant", ["q8", "none"])
def test_decode_chain_tokens_equal_a_step_loop(quant):
    cfg = ModelConfig(**TINY)
    if quant == "q8":
        params, dtype = bench.rand_qparams_unrolled_on_device(cfg, "cpu", seed=1), torch.bfloat16
    else:
        params, dtype = bench.rand_params_on_device(cfg, torch.float32, "cpu", seed=1), torch.float32
    step = make_decode_step(cfg)
    tokens = torch.tensor([3, 77], dtype=torch.int32)
    base = torch.tensor([5, 9], dtype=torch.int32)
    cache = init_kv_cache(cfg, 2, dtype=dtype, seq_len=32, device="cpu", quantized=True)
    got = bench.decode_chain(step, params, cache, tokens, base, 6)
    cache = init_kv_cache(cfg, 2, dtype=dtype, seq_len=32, device="cpu", quantized=True)
    want, tok = [], tokens
    for i in range(6):
        logits, cache = step(params, cache, tok, base + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        want.append(tok)
    assert got.shape == (6, 2) and got.dtype == torch.int32
    assert torch.equal(got, torch.stack(want))


@pytest.mark.parametrize("argv", [["--mode", "stream"], ["--attn", "xla"], ["--no-unroll"]],
                         ids=lambda a: " ".join(a))
def test_flags_not_yet_ported_print_the_error_line(capsys, argv):
    rc, line = _run(capsys, ["--device", "cpu"] + argv)
    assert rc == 1
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["metric"] == bench.metric_name(bench.parse_args(argv))[0]
    assert line["error"].startswith("args: NotImplementedError") and "not yet ported" in line["error"]


def test_a_missing_card_prints_the_backend_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc, line = _run(capsys, ["--steps", "4"])
    assert rc == 1
    assert line["metric"] == "decode_tok_per_s_per_chip_llama2_7b_int8_kv8_b8"
    assert line["error"].startswith("backend-init: RuntimeError")


def test_int4_paged_serve_is_refused_as_in_the_jax_bench(tiny, capsys):
    rc, line = _run(capsys, CPU + ["--mode", "serve", "--quant", "q4", "--paged"])
    assert rc == 1 and "q8/none only" in line["error"]
