"""Speculative decoding: a small draft model (or the prompt's own repeated
n-grams) proposes k tokens, the target verifies them in ONE chunked
prefill over the contiguous cache, and the longest accepted prefix plus a
correction or bonus token commits — the port of
hip_llama_tpu/engine/speculative.py.

Two verification rules, keyed on temperature:

* temperature 0 (greedy): accept the longest prefix where the draft matches
  the target's argmax. The output is exactly the target's greedy stream
  (InferenceEngine.generate at temperature 0).
* temperature > 0: rejection sampling. Draft token x_i is accepted with
  probability min(1, p_i(x_i) / q_i(x_i)), p and q the target's and the
  draft's warped (temperature + top-p) distributions; at the first rejection
  the replacement comes from norm(max(p_i - q_i, 0)); if all k pass, a bonus
  token comes from p_k. The committed stream is distributed as target-only
  sampling. Prompt-lookup proposals are the point-mass case q = 1.

`_warp` and `_verify_round` are numpy on the host and draw their coins from
the reference's xorshift64* stream (sampler.XorShift64Star): the same
inputs and seed give the JAX package's tokens exactly. The draft chain's
own stochastic draws come from a torch.Generator seeded with `seed`
(models/llama.py::make_logit_sampler), not from JAX's PRNG stream.

No rollback is needed: the rows the verify writes for rejected positions
sit at or past the new decode point, are never read (attention reads
strictly below the current position) and are written again by later steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from hip_llama_tpu_torch.engine.engine import BOS_ID, GenerationResult, InferenceEngine
from hip_llama_tpu_torch.models.llama import make_chunked_sampling_step
from hip_llama_tpu_torch.sampler import XorShift64Star, sample_mult, softmax_f32
from hip_llama_tpu_torch.tokenizer import printable_piece


@dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    rounds: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def _lookup_propose(history: list[int], k: int, max_ngram: int = 3) -> list[int]:
    """Prompt-lookup proposal (draft-free speculation): the k tokens that
    followed the most recent earlier occurrence of the trailing n-gram
    (longest n first, n <= max_ngram); nothing when no n-gram repeats (the
    caller then takes a plain step)."""
    ln = len(history)
    for n in range(min(max_ngram, ln - 1), 0, -1):
        key = history[ln - n:]
        for i in range(ln - n - 1, -1, -1):
            if history[i:i + n] == key:
                cont = history[i + n:i + n + k]
                if cont:
                    return cont
        if n == 1:
            break
    return []


def _warp(logits: np.ndarray, temperature: float, topp: float) -> np.ndarray:
    """The warped sampling distribution of the device sampler
    (models/llama.py::make_logit_sampler), in fp32 numpy: softmax at
    `temperature`, restricted to the top-p nucleus (the probabilities at
    least the smallest sorted one whose preceding mass is below topp),
    renormalized."""
    probs = softmax_f32(np.asarray(logits, np.float32) / np.float32(temperature))
    if 0.0 < topp < 1.0:
        sp = -np.sort(-probs)
        csum = np.cumsum(sp, dtype=np.float32)
        keep = csum - sp < np.float32(topp)  # the first one always kept
        thresh = sp[keep].min()
        probs = np.where(probs >= thresh, probs, np.float32(0.0))
    return probs / probs.sum(dtype=np.float32)


def _verify_round(
    ps: list[np.ndarray],
    qs: list[np.ndarray] | None,
    d_toks: list[int],
    rng: XorShift64Star,
) -> tuple[list[int], int]:
    """Rejection-sampling verification: ps = k + 1 target warped
    distributions, qs = k draft warped distributions (None: point-mass
    proposals, as prompt lookup's), d_toks = the k proposed tokens. Returns
    (committed tokens, n_accepted); the committed stream is distributed as
    sampling from ps one token at a time."""
    k = len(d_toks)
    commits: list[int] = []
    for i in range(k):
        x = d_toks[i]
        p = ps[i]
        px = float(p[x])
        qx = 1.0 if qs is None else float(qs[i][x])
        if qx <= 0.0:
            # the host's fp32 nucleus dropped a token the device sampler
            # kept (its true q is tiny but not 0): min(1, px / q) is about 1
            # where px > 0 and 0 where px == 0, so decide without a coin and
            # keep the stream deterministic per seed
            accept = px > 0.0
        else:
            accept = rng.next_f32() < min(1.0, px / qx)
        if accept:
            commits.append(x)
            continue
        # rejected: the replacement comes from norm(max(p - q, 0))
        if qs is None:
            resid = p.copy()
            resid[x] = 0.0
        else:
            resid = np.maximum(p - qs[i], np.float32(0.0))
        s = resid.sum(dtype=np.float32)
        if s <= 0.0:
            # p <= q everywhere up to rounding (p == q): x was fine
            commits.append(x)
            continue
        commits.append(sample_mult(resid / s, rng.next_f32()))
        return commits, i
    # every proposal accepted: a bonus token from the k-th target distribution
    commits.append(sample_mult(ps[k], rng.next_f32()))
    return commits, k


def speculative_generate(
    target: InferenceEngine,
    draft: InferenceEngine | None,
    prompt: str | None,
    steps: int | None = None,
    k: int = 4,
    echo: bool = False,
    temperature: float = 0.0,
    topp: float = 0.9,
    seed: int = 314028,
) -> tuple[GenerationResult, SpecStats]:
    """Generation from `target`, with proposals from a draft engine
    (draft=engine, sharing the tokenizer and vocab) or by prompt lookup
    (draft=None); k is the lookahead. Temperature 0 gives the target's
    greedy stream exactly; above it the target's warped distribution, by
    rejection sampling with xorshift64* coins from `seed`."""
    if target.paged or (draft is not None and draft.paged):
        raise ValueError("speculative decoding over paged caches not supported")
    stochastic = temperature > 0.0
    rng = XorShift64Star(seed)
    steps = min(steps or target.max_seq_len, target.max_seq_len)
    toks = target.tokenizer.encode(prompt or "", bos=True, eos=False)[:steps]

    # the verify is the engine's full-logits prefill: greedy takes its argmax
    # on the device and fetches k + 1 int32 a round, stochastic fetches the
    # k + 1 logit rows (the host needs the whole target distribution)
    def verify(cache, chunk: np.ndarray, start: int, valid: int):
        logits, cache = target._prefill(target.params, cache, target._dev(chunk),
                                        target._dev([start]), target._dev([valid]))
        if stochastic:
            return logits[0, :valid].cpu().numpy(), cache
        return torch.argmax(logits[0, :valid], dim=-1).cpu().numpy(), cache

    draft_chain = gen = None
    if draft is not None:
        # the whole proposal in one chain, sampled on the device
        draft_chain = make_chunked_sampling_step(draft.cfg, k, temperature=temperature,
                                                 topp=topp, return_logits=stochastic)
        gen = torch.Generator(device=draft.device).manual_seed(seed)

    t_cache = target.new_cache(batch=1)
    d_cache = draft.new_cache(batch=1) if draft is not None else None
    t0 = time.perf_counter()
    ttft = None
    stats = SpecStats()
    out_pieces: list[bytes] = []
    token_ids: list[int] = []

    def emit(prev: int, nxt: int) -> None:
        piece = printable_piece(target.tokenizer.decode_piece(prev, nxt))
        if echo and piece:
            print(piece.decode("utf-8", errors="replace"), end="", flush=True)
        out_pieces.append(piece)

    history = list(toks)
    pos = 0
    token = toks[0]
    if len(toks) > 1:
        _, t_cache = target._prefill_tokens(t_cache, 1, {0: toks[:-1]}, {0: 0})
        if draft is not None:
            # cut to the DRAFT's window; past it the proposals fall back to
            # prompt lookup (use_draft below)
            _, d_cache = draft._prefill_tokens(
                d_cache, 1, {0: toks[:-1][:draft.max_seq_len - 1]}, {0: 0})
        pos = len(toks) - 1
        token = toks[-1]
        for a, nxt in zip(toks, toks[1:]):
            emit(a, nxt)

    done = False
    while pos < steps and not done:
        # the verify chunk writes rows pos..pos+kk, inside the target's
        # window: the lookahead shrinks near its end
        kk = min(k, target.max_seq_len - 1 - pos)
        if kk < 1:
            break
        # a draft whose window is spent hands over to prompt lookup, so the
        # target keeps generating past it
        use_draft = draft is not None and pos + 1 < draft.max_seq_len
        if use_draft:
            kk = min(kk, draft.max_seq_len - 1 - pos)

        # 1) propose kk tokens from (token, pos); stochastic drafts also give
        # qs, their warped distribution at each position
        qs: list[np.ndarray] | None = None
        if use_draft:
            if kk == k:
                out = draft_chain(draft.params, d_cache, draft._dev([token]), draft._dev([pos]),
                                  gen)
                d_cache = out[-1]
                if stochastic:
                    qs = [_warp(row, temperature, topp) for row in out[1][0].cpu().numpy()]
                d_toks = [int(x) for x in out[0][0].cpu().numpy()]
            else:
                d_toks = []
                qs = [] if stochastic else None
                d_tok, d_pos = token, pos
                for _ in range(kk):
                    logits, d_cache = draft._do_step(d_cache, np.array([d_tok], np.int32),
                                                     np.array([d_pos], np.int32))
                    if stochastic:
                        q = _warp(logits[0], temperature, topp)
                        d_tok = sample_mult(q, rng.next_f32())
                        qs.append(q)
                    else:
                        d_tok = int(np.argmax(logits[0]))
                    d_toks.append(d_tok)
                    d_pos += 1
        else:
            d_toks = _lookup_propose(history, kk)
            kk = len(d_toks)
            if kk == 0:
                # no repeating n-gram: one plain (greedy or sampled) step
                logits, t_cache = target._do_step(t_cache, np.array([token], np.int32),
                                                  np.array([pos], np.int32))
                if stochastic:
                    nxt = sample_mult(_warp(logits[0], temperature, topp), rng.next_f32())
                else:
                    nxt = int(np.argmax(logits[0]))
                pos += 1
                if ttft is None:
                    ttft = time.perf_counter() - t0
                if nxt == BOS_ID:
                    break
                emit(token, nxt)
                token_ids.append(nxt)
                history.append(nxt)
                token = nxt
                continue

        # 2) the target verifies all kk + 1 positions in one prefill, padded
        # to the smallest prefill bucket that holds them
        tb = next((x for x in sorted(target.prefill_buckets) if x >= kk + 1), kk + 1)
        chunk = np.zeros((1, tb), np.int32)
        chunk[0, : kk + 1] = [token] + d_toks
        g, t_cache = verify(t_cache, chunk, pos, kk + 1)

        # 3) accept: greedy takes the longest argmax-matching prefix and the
        # correction; stochastic rejection-samples against the target
        if stochastic:
            ps = [_warp(row, temperature, topp) for row in g]
            commits, n_acc = _verify_round(ps, qs, d_toks, rng)
        else:
            n_acc = 0
            while n_acc < kk and d_toks[n_acc] == int(g[n_acc]):
                n_acc += 1
            commits = d_toks[:n_acc] + [int(g[n_acc])]
        if use_draft and n_acc == kk:
            # full acceptance: drop the bonus. The draft chain never wrote
            # the row of its LAST proposal, so committing past it would leave
            # a hole in the draft's cache; the next round derives the dropped
            # token again
            commits = commits[:n_acc]
        stats.proposed += kk
        stats.accepted += n_acc
        stats.rounds += 1

        for nxt in commits:
            if pos >= steps:
                break
            pos += 1
            if ttft is None:
                ttft = time.perf_counter() - t0
            if nxt == BOS_ID:  # the reference's stop (llama.cpp:556-558)
                done = True
                break
            emit(token, nxt)
            token_ids.append(nxt)
            history.append(nxt)
            token = nxt

    elapsed = time.perf_counter() - t0
    return (
        GenerationResult(
            text=b"".join(out_pieces).decode("utf-8", errors="replace"),
            token_ids=token_ids,
            n_gen_tokens=max(pos - 1, 0),
            elapsed_s=elapsed,
            ttft_s=ttft if ttft is not None else elapsed,
        ),
        stats,
    )
