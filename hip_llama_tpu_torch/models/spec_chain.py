"""Speculative rounds with no host round trip: N whole rounds (proposal,
bucketed verify, accept and commit) enqueued back to back on the device —
the port of hip_llama_tpu/models/spec_chain.py, whose `lax.scan` over
rounds becomes a Python loop that keeps every value on the device.

Per round (greedy, one slot):
1. PROPOSE: prompt lookup on the device. The most recent occurrence of the
   current bigram in an (H,) history buffer proposes the k tokens that
   followed it (engine/speculative.py::_lookup_propose does the host's
   n-gram lookup); no match proposes -7, which never equals a token, so the
   round commits one corrected token, a plain step's worth.
2. VERIFY: one chunked prefill of the k + 1 candidate rows through the
   target (models/llama.py::make_prefill, every row's logits).
3. ACCEPT and COMMIT: the longest prefix matching the target's argmax, then
   the correction from the verify logits. Rows past the accepted prefix are
   written again by the next round before they are read.

Greedy output equals the plain greedy chain (tests/test_torch_spec_chain.py).
"""

from __future__ import annotations

import torch

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.models.llama import make_decode_step, make_prefill

NO_TOKEN = -7  # pads the history and stands for "no proposal"


def make_spec_lookup_chain(cfg: ModelConfig, *, k: int = 4, n_rounds: int = 32,
                           hist_len: int = 512, plain: bool = False):
    """Returns chain(params, cache, token () int32, pos () int32, hist (H,)
    int32) -> (out_tokens (n_rounds, k + 1) int32, out_counts (n_rounds,)
    int32, cache, next_token, next_pos, hist), every tensor on the cache's
    device.

    `hist` carries the recent committed stream (seed it with the prompt's
    tail, the rest NO_TOKEN). Row r of out_tokens holds round r's committed
    tokens left-aligned and out_counts[r] their number (n_acc + 1). The
    positions must stay below the cache window: pos + n_rounds * (k + 1) <
    S. Greedy only."""
    t_bucket = -(-(k + 1) // 8) * 8
    prefill = make_prefill(cfg, plain=plain)
    H = hist_len

    def chain(params, cache, token, pos, hist):
        dev = hist.device
        idx = torch.arange(H, device=dev)
        ik = torch.arange(k, device=dev)
        i = torch.arange(k + 1, device=dev)
        no_props = torch.full((k,), NO_TOKEN, dtype=torch.int32, device=dev)
        valid = torch.full((1,), k + 1, dtype=torch.int32, device=dev)
        out_toks, out_counts = [], []
        for _ in range(n_rounds):
            # hist ends with the current token; the last earlier occurrence
            # j of the bigram (hist[-2], token), hist[j - 1] == hist[-2] and
            # hist[j] == token, proposes hist[j + 1 : j + 1 + k]
            match = ((hist == token) & (torch.roll(hist, 1) == hist[H - 2])
                     & (idx > 0) & (idx < H - 1))
            best = torch.where(match, idx, -1).amax()
            ext = torch.cat([hist, no_props])
            props = torch.where(best >= 0, ext[(best + 1).clamp(min=0) + ik], no_props)
            seq = torch.zeros((1, t_bucket), dtype=torch.int32, device=dev)
            seq[0, 0] = token
            seq[0, 1:k + 1] = props.clamp(min=0)
            logits, cache = prefill(params, cache, seq, pos.view(1), valid)
            greedy = torch.argmax(logits[0, : k + 1], dim=-1).to(torch.int32)
            n_acc = torch.cumprod((props == greedy[:k]).to(torch.int32), dim=0).sum()
            nxt = greedy.gather(0, n_acc.view(1))[0]  # no host sync, as greedy[n_acc] would
            m = (n_acc + 1).to(torch.int32)
            committed = torch.where(i < n_acc, props.clamp(min=0)[i.clamp(max=k - 1)],
                                    torch.where(i == n_acc, nxt, 0)).to(torch.int32)
            # shift the history left by m and append the m committed tokens
            hist = torch.cat([hist, committed])[idx + m]
            token, pos = nxt, pos + m
            out_toks.append(committed)
            out_counts.append(m.to(torch.int32))
        return torch.stack(out_toks), torch.stack(out_counts), cache, token, pos, hist

    return chain


def make_plain_chain(cfg: ModelConfig, *, n_steps: int, plain: bool = False):
    """The baseline: chain(params, cache, token () int32, pos () int32) ->
    (tokens (n_steps,) int32, cache, next_token, next_pos), n_steps greedy
    decode steps of one slot fed on the device — the denominator of the
    speculative multiplier."""
    step = make_decode_step(cfg, plain=plain)

    def chain(params, cache, token, pos):
        toks = []
        for _ in range(n_steps):
            logits, cache = step(params, cache, token.view(1), pos.view(1))
            token = torch.argmax(logits[0]).to(torch.int32)
            pos = pos + 1
            toks.append(token)
        return torch.stack(toks), cache, token, pos

    return chain
