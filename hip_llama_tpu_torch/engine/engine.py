"""Inference engine: single-prompt generation and continuous batching — the
port of hip_llama_tpu/engine/engine.py's contiguous-cache path.

The batch is ONE fixed-shape step over a slot array; the slot state machine
lives on the host exactly like the reference's (fill / step / sample /
retire on BOS-or-EOS-or-length, llama.cpp:968-1073). New requests are
chunk-prefilled in bucketed shapes instead of being force-fed one token per
step. Sampling runs on the host with the reference's xorshift64* samplers,
so every step copies the (B, V) fp32 logits to the host.

The scheduler is the Python loop; the JAX package's native C++ scheduler,
the paged cache, speculation, multi-step chunks and device sampling are not
ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine.requests import Requests
from hip_llama_tpu_torch.models.llama import (
    KVCache,
    act_dtype,
    init_kv_cache,
    make_decode_step,
    make_prefill,
)
from hip_llama_tpu_torch.models.params import LlamaParams, QuantLlamaParams
from hip_llama_tpu_torch.sampler import Sampler, request_sampler
from hip_llama_tpu_torch.tokenizer import BOS_ID, EOS_ID, Tokenizer, printable_piece


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    n_gen_tokens: int
    elapsed_s: float
    ttft_s: float

    @property
    def tok_per_s(self) -> float:
        return self.n_gen_tokens / self.elapsed_s if self.elapsed_s > 0 else 0.0


# prefill chunk lengths (engine.py:170 of the JAX package): a few shapes, and
# a long prompt in chunks of the largest
PREFILL_BUCKETS = (16, 64, 256)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: LlamaParams | QuantLlamaParams,
        tokenizer: Tokenizer,
        *,
        batch_size: int = 8,
        max_seq_len: int | None = None,
        use_prefill: bool = True,
    ):
        """The engine runs on its params' device, with a KV cache of the
        activation dtype (the dense params' dtype, bf16 for Q8 params) and
        `max_seq_len` rows (default: the model's)."""
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.device = params.device
        self.max_seq_len = max_seq_len or cfg.seq_len
        self.use_prefill = use_prefill
        self.prefill_buckets = tuple(
            b for b in PREFILL_BUCKETS if b <= self.max_seq_len
        ) or (min(16, self.max_seq_len),)
        # prefill chunks run so far, by bucket size T
        self.prefill_chunks: collections.Counter[int] = collections.Counter()
        self._step = make_decode_step(cfg)
        # chunked-scheduler prefill: logits for each slot's LAST valid row
        # only — the (B, T, V) classifier and its host copy are skipped
        self._prefill_last = make_prefill(cfg, last_only=True)

    # -- helpers ------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    def new_cache(self, batch: int | None = None) -> KVCache:
        return init_kv_cache(
            self.cfg, batch or self.batch_size, dtype=act_dtype(self.params),
            seq_len=self.max_seq_len, device=self.device,
        )

    def _do_step(self, cache, tokens: np.ndarray, pos: np.ndarray):
        logits, cache = self._step(self.params, cache, self._dev(tokens), self._dev(pos))
        return logits.cpu().numpy(), cache

    def _prefill_tokens(
        self,
        cache: KVCache,
        batch: int,
        slot_tokens: dict[int, list[int]],
        slot_start: dict[int, int],
    ) -> tuple[np.ndarray | None, KVCache]:
        """Prefill each slot's token list starting at its offset, in
        bucketed chunks. Returns the logits (B, V) at each slot's final
        prefilled position (None if no tokens were prefilled) and the
        cache."""
        if not slot_tokens:
            return None, cache
        remaining = {s: list(t) for s, t in slot_tokens.items() if t}
        offset = dict(slot_start)
        last_logits = np.zeros((batch, self.cfg.vocab_size), np.float32)
        while any(remaining.values()):
            t = _bucket(max(len(v) for v in remaining.values()), self.prefill_buckets)
            toks = np.zeros((batch, t), np.int32)
            start = np.zeros((batch,), np.int32)
            valid = np.zeros((batch,), np.int32)
            for s, v in remaining.items():
                chunk = v[:t]
                toks[s, : len(chunk)] = chunk
                start[s] = offset[s]
                valid[s] = len(chunk)
                offset[s] += len(chunk)
                remaining[s] = v[t:]
            logits, cache = self._prefill_last(
                self.params, cache, self._dev(toks), self._dev(start), self._dev(valid)
            )
            self.prefill_chunks[t] += 1
            logits_h = logits.cpu().numpy()
            for s in list(remaining):
                if valid[s] > 0:
                    last_logits[s] = logits_h[s]
        return last_logits, cache

    # -- generate mode (llama.cpp:522-579) -----------------------------------

    def generate(
        self,
        prompt: str | None,
        steps: int | None = None,
        sampler: Sampler | None = None,
        echo: bool = False,
    ) -> GenerationResult:
        cfg = self.cfg
        steps = min(steps or self.max_seq_len, self.max_seq_len)
        sampler = sampler or Sampler(cfg.vocab_size, temperature=0.0)
        prompt_tokens = self.tokenizer.encode(prompt or "", bos=True, eos=False)

        cache = self.new_cache(batch=1)
        t0 = time.perf_counter()
        ttft = None
        out_pieces: list[bytes] = []
        token_ids: list[int] = []

        pos = 0
        token = prompt_tokens[0]
        if self.use_prefill and len(prompt_tokens) > 1:
            # prefill all but the last prompt token; the decode step below
            # consumes the last one and produces the first sampled logits. A
            # prompt longer than the step budget is truncated at it, as the
            # reference's per-step pos < steps bound does (llama.cpp:540)
            n_feed = min(len(prompt_tokens) - 1, steps)
            _, cache = self._prefill_tokens(cache, 1, {0: prompt_tokens[:n_feed]}, {0: 0})
            pos = n_feed
            token = prompt_tokens[min(n_feed, len(prompt_tokens) - 1)]
            # the prompt echo the reference prints while force-feeding
            # (llama.cpp:560-563)
            for a, nxt in zip(prompt_tokens[:n_feed], prompt_tokens[1:n_feed + 1]):
                piece = printable_piece(self.tokenizer.decode_piece(a, nxt))
                if echo and piece:
                    print(piece.decode("utf-8", errors="replace"), end="", flush=True)
                out_pieces.append(piece)

        while pos < steps:
            logits, cache = self._do_step(
                cache, np.array([token], np.int32), np.array([pos], np.int32)
            )
            if pos < len(prompt_tokens) - 1:
                nxt = prompt_tokens[pos + 1]
            else:
                nxt = sampler.sample(logits[0])
                if ttft is None:
                    ttft = time.perf_counter() - t0
            pos += 1
            # data-dependent terminating condition: BOS (llama.cpp:556-558)
            if nxt == BOS_ID:
                break
            piece = printable_piece(self.tokenizer.decode_piece(token, nxt))
            if echo and piece:
                print(piece.decode("utf-8", errors="replace"), end="", flush=True)
            if pos > len(prompt_tokens) - 1:
                token_ids.append(nxt)
            out_pieces.append(piece)
            token = nxt

        elapsed = time.perf_counter() - t0
        return GenerationResult(
            text=b"".join(out_pieces).decode("utf-8", errors="replace"),
            token_ids=token_ids,
            n_gen_tokens=max(pos - 1, 0),
            elapsed_s=elapsed,
            ttft_s=ttft if ttft is not None else elapsed,
        )

    # -- test mode: continuous batching (llama.cpp:891-1083) -----------------

    def serve(
        self,
        requests: Requests,
        steps: int | None = None,
        samplers: list[Sampler] | None = None,
        verbose: bool = False,
        stats: dict | None = None,
        stop_on_eos: bool = True,
    ) -> int:
        """Continuous batching over a request list; fills
        `requests.generations` in place and returns the generated-token count
        (the reference's gen_cnt, llama.cpp:1062).

        `stats`, if given, is filled with serving metrics: wall time, tok/s,
        per-request TTFT p50/p95/max and scheduler iterations.

        `stop_on_eos`: True retires a slot on EOS like the reference's GPU
        scheduler (llama.cpp:1052-1056); False stops on BOS only, as the
        reference's CPU engine (run.cc:1075-1077) that the golden corpora
        were made with."""
        cfg = self.cfg
        b = self.batch_size
        steps = min(steps or self.max_seq_len, self.max_seq_len)
        if samplers is None:
            # per-request fixed-seed samplers (llama.cpp:897-900)
            samplers = [request_sampler(cfg.vocab_size) for _ in requests.prompts]
        t_start = time.perf_counter()
        assign_time = [0.0] * requests.num_reqs
        ttft: list[float | None] = [None] * requests.num_reqs

        cache = self.new_cache(batch=b)
        next_req = 0
        gen_cnt = 0
        req_id = [-1] * b  # batch_token_id
        token = np.zeros(b, np.int32)
        pos = np.zeros(b, np.int32)
        prompt_toks: list[list[int]] = [[] for _ in range(b)]
        gen_bytes: list[bytearray] = [bytearray() for _ in range(b)]

        sched_iters = 0
        while True:
            sched_iters += 1
            # assign new requests to empty slots (llama.cpp:973-1007)
            newly_assigned: dict[int, list[int]] = {}
            n_idle = 0
            for s in range(b):
                if req_id[s] != -1:
                    continue
                if next_req >= requests.num_reqs:
                    n_idle += 1
                    continue
                ridx = next_req
                next_req += 1
                toks = self.tokenizer.encode(requests.prompts[ridx], bos=True, eos=False)
                # a prompt longer than the step budget truncates at it (the
                # reference's pos < steps bound, llama.cpp:1027-1049); keeps
                # every KV write inside the window
                toks = toks[:steps]
                req_id[s] = ridx
                assign_time[ridx] = time.perf_counter()
                prompt_toks[s] = toks
                gen_bytes[s] = bytearray()
                token[s] = toks[0]
                pos[s] = 0
                if self.use_prefill and len(toks) > 1:
                    newly_assigned[s] = toks[:-1]
                    token[s] = toks[-1]
                    pos[s] = len(toks) - 1
                    # prompt echo parity: the reference appends decoded pieces
                    # while force-feeding (llama.cpp:1040-1046)
                    for a, nx in zip(toks, toks[1:]):
                        gen_bytes[s] += printable_piece(self.tokenizer.decode_piece(a, nx))
                if verbose:
                    print(f"slot {s} <- request {req_id[s]}")
            if n_idle == b:
                break

            if newly_assigned:
                _, cache = self._prefill_tokens(
                    cache, b, newly_assigned, {s: 0 for s in newly_assigned}
                )

            logits_h, cache = self._do_step(cache, token, pos)
            # advance the slot state machines (llama.cpp:1027-1049)
            for s in range(b):
                if req_id[s] == -1:
                    continue
                in_prompt = pos[s] < len(prompt_toks[s]) - 1
                if in_prompt:
                    nxt = prompt_toks[s][pos[s] + 1]
                else:
                    nxt = samplers[req_id[s]].sample(logits_h[s])
                    if ttft[req_id[s]] is None:
                        ttft[req_id[s]] = time.perf_counter() - assign_time[req_id[s]]
                pos[s] += 1
                done = nxt == BOS_ID or (stop_on_eos and nxt == EOS_ID)
                if not done:
                    gen_bytes[s] += printable_piece(
                        self.tokenizer.decode_piece(int(token[s]), nxt)
                    )
                    token[s] = nxt
                    done = pos[s] >= steps
                if done:  # retire (llama.cpp:1052-1070)
                    requests.generations[req_id[s]] = (
                        gen_bytes[s].decode("utf-8", errors="replace") + "\n"
                    )
                    gen_cnt += int(pos[s]) - 1
                    if verbose:
                        print(f"slot {s} DONE request {req_id[s]}")
                    req_id[s] = -1
                    pos[s] = 0
                    token[s] = 0

        if stats is not None:
            elapsed = time.perf_counter() - t_start
            tt = sorted(t for t in ttft if t is not None)
            stats.update(
                total_tokens=gen_cnt,
                elapsed_s=elapsed,
                tok_per_s=gen_cnt / elapsed if elapsed > 0 else 0.0,
                ttft_p50_s=tt[len(tt) // 2] if tt else None,
                ttft_p95_s=tt[min(len(tt) - 1, int(len(tt) * 0.95))] if tt else None,
                ttft_max_s=tt[-1] if tt else None,
                ttft_all_s=tt,
                scheduler_iters=sched_iters,
                slot_steps=sched_iters * b,
            )
        return gen_cnt
