"""Inference engine: single-prompt generation and continuous batching — the
port of hip_llama_tpu/engine/engine.py's contiguous-cache path.

The batch is ONE fixed-shape step over a slot array; the slot state machine
lives on the host exactly like the reference's (fill / step / sample /
retire on BOS-or-EOS-or-length, llama.cpp:968-1073). New requests are
chunk-prefilled in bucketed shapes instead of being force-fed one token per
step. Sampling runs on the host with the reference's xorshift64* samplers,
so every step copies the (B, V) fp32 logits to the host.

With `paged=True` the KV cache is the paged pool (models/paged.py) and a
host-side BlockManager hands out its pages (engine.py:172-187, :267-296,
:394-453 of the JAX package): admission control holds a request back until
its prompt can get pages, and with `prefix_cache=True` identical prompt
prefixes share pages and skip their prefill.

The decode loop has the JAX engine's alternative dispatch schedules
(engine.py:181-306, :543-566, :627-702, :897-1066 of the JAX package):
- `device_sampling`: each step samples on the device (models/llama.py::
  make_sampling_decode_step) and the host fetches 4 bytes a slot;
- `chunk_steps=N`: when every active slot is past its prompt and has N
  steps of budget left, N steps run back to back with the sampled tokens
  fed on the device (make_chunked_sampling_step; on pages, with the pages
  of the whole chunk reserved first, or single steps while the pool cannot
  cover it), and the scheduler walks the (B, N) tokens, discarding what a
  slot emits after it retires;
- `spec_lookup=K`: each active slot proposes up to K tokens from its own
  repeated n-grams, or with `serve(draft=...)` from one batched greedy chain
  of a draft engine, and one full-logits prefill over the contiguous cache
  verifies the whole batch (engine/speculative.py semantics).
Stochastic device draws come from one torch.Generator on the engine's
device seeded with `ds_seed`, not from JAX's PRNG stream.

The scheduler is the Python loop; the JAX package's native C++ scheduler
and replicas are not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from hip_llama_tpu_torch.config import ModelConfig
from hip_llama_tpu_torch.engine.block_manager import BlockManager, OutOfPagesError
from hip_llama_tpu_torch.engine.requests import Requests
from hip_llama_tpu_torch.models.llama import (
    KVCache,
    act_dtype,
    init_kv_cache,
    make_chunked_sampling_step,
    make_decode_step,
    make_prefill,
    make_sampling_decode_step,
)
from hip_llama_tpu_torch.models.paged import (
    PagedKVCache,
    init_paged_kv_cache,
    make_paged_chunked_sampling_step,
    make_paged_decode_step,
    make_paged_prefill,
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
        kv_quant: bool = False,
        paged: bool = False,
        page_size: int = 128,
        num_pages: int | None = None,
        prefix_cache: bool = False,
        device_sampling: bool = False,
        ds_temperature: float = 0.0,
        ds_topp: float = 0.9,
        ds_seed: int = 0,
        chunk_steps: int = 1,
        spec_lookup: int = 0,
    ):
        """The engine runs on its params' device, with a KV cache of the
        activation dtype (the dense params' dtype, bf16 for Q8 params), or
        int8 with per-row scales when `kv_quant`, and `max_seq_len` rows
        (default: the model's). `paged`: the cache is a pool of `num_pages`
        pages of `page_size` rows (default: batch x ceil(max_seq_len /
        page_size)) plus the trash page; `prefix_cache` shares the pages of
        identical prompt prefixes (paged, with prefill).

        `device_sampling` samples each step on the device (contiguous cache
        only), `chunk_steps` > 1 decodes that many steps a dispatch where the
        schedule allows, both at `ds_temperature` / `ds_topp` with draws
        from a torch.Generator seeded with `ds_seed`; `spec_lookup` > 0
        verifies up to that many proposed tokens a slot per prefill
        (contiguous cache, with prefill, neither of the other two). Each
        rule raises ValueError where the JAX engine's does."""
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.device = params.device
        self.max_seq_len = max_seq_len or cfg.seq_len
        self.use_prefill = use_prefill
        self.kv_quant = kv_quant
        self.prefill_buckets = tuple(
            b for b in PREFILL_BUCKETS if b <= self.max_seq_len
        ) or (min(16, self.max_seq_len),)
        self.paged = paged
        self.page_size = page_size
        self.spec_lookup = spec_lookup
        if spec_lookup:
            # the verify IS a prefill, at starts that are not page-aligned
            if paged:
                raise ValueError("spec_lookup requires paged=False")
            if not use_prefill:
                raise ValueError("spec_lookup requires use_prefill=True")
            if chunk_steps > 1 or device_sampling:
                raise ValueError("spec_lookup is incompatible with chunk_steps/"
                                 "device_sampling (each is its own dispatch schedule)")
        if device_sampling and paged:
            # the sampling step drives the contiguous cache
            raise ValueError("device_sampling is not supported with paged=True")
        self.prefix_cache = prefix_cache
        if prefix_cache and not paged:
            raise ValueError("prefix_cache requires paged=True (shared pages)")
        if prefix_cache and not use_prefill:
            # force-feeding writes every prompt row through the decode step,
            # which would scribble on shared pages
            raise ValueError("prefix_cache requires use_prefill=True")
        # prefill chunks run so far, by bucket size T
        self.prefill_chunks: collections.Counter[int] = collections.Counter()
        if paged:
            # paged prefill needs page-aligned chunk starts: chunks of
            # exactly one page
            self.prefill_buckets = (page_size,)
            self.num_pages = num_pages or batch_size * -(-self.max_seq_len // page_size)
            self.max_pages = -(-self.max_seq_len // page_size)
            self._step = make_paged_decode_step(cfg)
            self._prefill_last = make_paged_prefill(cfg, last_only=True)
        else:
            self._step = make_decode_step(cfg)
            # chunked-scheduler prefill: logits for each slot's LAST valid
            # row only — the (B, T, V) classifier and its host copy are
            # skipped
            self._prefill_last = make_prefill(cfg, last_only=True)
            # every row's logits: the speculative verify reads them all
            self._prefill = make_prefill(cfg)
        self.chunk_steps = chunk_steps
        self._chunk = self._sstep = self._ds_gen = None
        if chunk_steps > 1:
            make = make_paged_chunked_sampling_step if paged else make_chunked_sampling_step
            self._chunk = make(cfg, chunk_steps, temperature=ds_temperature, topp=ds_topp)
        if device_sampling:
            self._sstep = make_sampling_decode_step(cfg, temperature=ds_temperature, topp=ds_topp)
        if self._chunk is not None or self._sstep is not None:
            self._ds_gen = torch.Generator(device=self.device).manual_seed(ds_seed)

    # -- helpers ------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    def new_cache(self, batch: int | None = None) -> KVCache | PagedKVCache:
        b = batch or self.batch_size
        if self.paged:
            # at least one page per slot; +1: physical page 0 is the
            # BlockManager's trash page (idle-slot writes land there)
            return init_paged_kv_cache(
                self.cfg, max(self.num_pages, b) + 1, self.page_size,
                dtype=act_dtype(self.params), quantized=self.kv_quant, device=self.device,
            )
        return init_kv_cache(
            self.cfg, b, dtype=act_dtype(self.params),
            seq_len=self.max_seq_len, device=self.device, quantized=self.kv_quant,
        )

    def new_block_manager(self, batch: int | None = None) -> BlockManager | None:
        if not self.paged:
            return None
        b = batch or self.batch_size
        return BlockManager(num_pages=max(self.num_pages, b), page_size=self.page_size,
                            num_slots=b)

    def _table(self, bm: BlockManager, b: int) -> torch.Tensor:
        return self._dev(np.array([bm.table_array(s, self.max_pages) for s in range(b)]))

    def _do_step(self, cache, tokens: np.ndarray, pos: np.ndarray, bm: BlockManager | None = None):
        args = (self._dev(tokens), self._dev(pos))
        if self.paged:
            args = (self._table(bm, len(tokens)),) + args
        logits, cache = self._step(self.params, cache, *args)
        return logits.cpu().numpy(), cache

    def _prefill_tokens(
        self,
        cache: KVCache,
        batch: int,
        slot_tokens: dict[int, list[int]],
        slot_start: dict[int, int],
        bm: BlockManager | None = None,
    ) -> tuple[np.ndarray | None, KVCache]:
        """Prefill each slot's token list starting at its offset, in
        bucketed chunks (on the paged pool, `bm` allocates each chunk's
        pages first). Returns the logits (B, V) at each slot's final
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
                if bm is not None and valid[s]:
                    bm.ensure_capacity(s, int(start[s]) + int(valid[s]))
            args = (self._dev(toks), self._dev(start), self._dev(valid))
            if self.paged:
                args = (self._table(bm, batch),) + args
            logits, cache = self._prefill_last(self.params, cache, *args)
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
        bm = self.new_block_manager(batch=1)
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
            _, cache = self._prefill_tokens(cache, 1, {0: prompt_tokens[:n_feed]}, {0: 0}, bm=bm)
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
            if bm is not None:
                bm.append_token(0, pos)
            if self._sstep is not None:
                nxt_dev, cache = self._sstep(self.params, cache, self._dev([token]),
                                             self._dev([pos]), self._ds_gen)
                logits = None
            else:
                logits, cache = self._do_step(
                    cache, np.array([token], np.int32), np.array([pos], np.int32), bm
                )
            if pos < len(prompt_tokens) - 1:
                nxt = prompt_tokens[pos + 1]
            else:
                nxt = int(nxt_dev[0]) if logits is None else sampler.sample(logits[0])
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
        draft: "InferenceEngine | None" = None,
    ) -> int:
        """Continuous batching over a request list; fills
        `requests.generations` in place and returns the generated-token count
        (the reference's gen_cnt, llama.cpp:1062).

        `stats`, if given, is filled with serving metrics: wall time, tok/s,
        per-request TTFT p50/p95/max, scheduler iterations, the prompt
        tokens served from shared prefix pages and the speculation counts
        (`spec_proposed`, `spec_accepted`).

        On the paged pool a request whose prompt cannot get pages waits for
        a retirement (held back, ahead of the requests after it); one that
        cannot get them with no slot active raises RuntimeError.

        `stop_on_eos`: True retires a slot on EOS like the reference's GPU
        scheduler (llama.cpp:1052-1056); False stops on BOS only, as the
        reference's CPU engine (run.cc:1075-1077) that the golden corpora
        were made with.

        `draft` (with spec_lookup > 0): an engine sharing the vocab whose
        one batched greedy chain of spec_lookup steps proposes each round's
        tokens instead of the n-gram lookup. Its cache follows the committed
        stream: the rows of rejected proposals sit at or past the next
        position and are written again before they are read (engine/
        speculative.py). A slot within spec_lookup rows of the draft's
        window proposes by lookup instead."""
        # imported here: engine/speculative.py imports this module
        from hip_llama_tpu_torch.engine.speculative import _lookup_propose, _verify_round, _warp

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
        bm = self.new_block_manager(batch=b)
        next_req = 0
        # admission-blocked requests wait here with their tokens, so a retry
        # does not encode the prompt again
        held_back: list[int] = []
        tok_cache: dict[int, list[int]] = {}
        gen_cnt = 0
        req_id = [-1] * b  # batch_token_id
        token = np.zeros(b, np.int32)
        pos = np.zeros(b, np.int32)
        prompt_toks: list[list[int]] = [[] for _ in range(b)]
        gen_bytes: list[bytearray] = [bytearray() for _ in range(b)]
        # each slot's token stream, for the lookup proposals
        hist: list[list[int]] = [[] for _ in range(b)]
        spec_proposed = spec_accepted = 0
        d_cache = d_chain = None
        if draft is not None:
            if not self.spec_lookup:
                raise ValueError("serve(draft=...) requires spec_lookup > 0")
            d_cache = draft.new_cache(batch=b)
            d_chain = make_chunked_sampling_step(draft.cfg, self.spec_lookup, temperature=0.0)

        def retire_slot(s: int) -> None:
            nonlocal gen_cnt
            requests.generations[req_id[s]] = gen_bytes[s].decode("utf-8", errors="replace") + "\n"
            gen_cnt += int(pos[s]) - 1
            if verbose:
                print(f"slot {s} DONE request {req_id[s]}")
            req_id[s] = -1
            pos[s] = 0
            token[s] = 0
            if bm is not None:
                bm.free_slot(s)

        def commit(s: int, nxt: int, in_prompt: bool = False) -> bool:
            """Advance slot s by the token `nxt` (llama.cpp:1027-1049);
            True when the slot is done."""
            if not in_prompt and ttft[req_id[s]] is None:
                ttft[req_id[s]] = time.perf_counter() - assign_time[req_id[s]]
            pos[s] += 1
            if nxt == BOS_ID or (stop_on_eos and nxt == EOS_ID):
                return True
            gen_bytes[s] += printable_piece(self.tokenizer.decode_piece(int(token[s]), nxt))
            token[s] = nxt
            if not in_prompt:  # prompt tokens are in hist already
                hist[s].append(nxt)
            return bool(pos[s] >= steps)

        def advance_and_retire(logits_h, nxt_h) -> None:
            """One step's tokens for every active slot: from the host
            samplers over `logits_h` (B, V), or sampled on the device
            (`nxt_h` (B,)); a slot still inside its prompt is fed its next
            prompt token instead. Done slots retire (llama.cpp:1052-1070)."""
            for s in range(b):
                if req_id[s] == -1:
                    continue
                in_prompt = pos[s] < len(prompt_toks[s]) - 1
                if in_prompt:
                    nxt = prompt_toks[s][pos[s] + 1]
                elif logits_h is None:
                    nxt = int(nxt_h[s])
                else:
                    nxt = samplers[req_id[s]].sample(logits_h[s])
                if commit(s, nxt, in_prompt):
                    retire_slot(s)

        sched_iters = 0
        while True:
            sched_iters += 1
            # assign new requests to empty slots (llama.cpp:973-1007)
            newly_assigned: dict[int, list[int]] = {}
            prefill_start: dict[int, int] = {}
            n_idle = 0
            for s in range(b):
                if req_id[s] != -1:
                    continue
                if held_back:
                    ridx = held_back.pop(0)
                elif next_req < requests.num_reqs:
                    ridx = next_req
                    next_req += 1
                else:
                    n_idle += 1
                    continue
                toks = tok_cache.pop(ridx, None)
                if toks is None:
                    # a prompt longer than the step budget truncates at it
                    # (the reference's pos < steps bound, llama.cpp:1027-
                    # 1049); keeps every KV write inside the window
                    toks = self.tokenizer.encode(requests.prompts[ridx], bos=True,
                                                 eos=False)[:steps]
                n_cached = 0
                if bm is not None:
                    # prefix cache: attach indexed prompt-prefix pages
                    # (shared, refcounted) before sizing the remainder
                    if self.prefix_cache and len(toks) > 1:
                        n_cached = bm.match_prefix(s, toks)
                    # admission control: a prompt that cannot get its pages
                    # waits for a retirement
                    need = -(-(len(toks) + 1) // self.page_size) - len(bm.page_tables[s])
                    if bm.num_free < need:
                        tok_cache[ridx] = toks
                        held_back.insert(0, ridx)
                        free_before = bm.num_free
                        bm.free_slot(s)  # detach matched prefix pages
                        if all(r == -1 for r in req_id):
                            raise RuntimeError(
                                f"prompt needs {need} more KV pages beyond its {n_cached}-token "
                                f"cached prefix but the pool has {free_before} free in total")
                        continue
                    bm.prefix_hit_tokens += n_cached
                req_id[s] = ridx
                assign_time[ridx] = time.perf_counter()
                prompt_toks[s] = toks
                hist[s] = list(toks)
                gen_bytes[s] = bytearray()
                token[s] = toks[0]
                pos[s] = 0
                if self.use_prefill and len(toks) > 1:
                    # skip prompt rows served by the prefix cache
                    newly_assigned[s] = toks[n_cached:-1]
                    prefill_start[s] = n_cached
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
                _, cache = self._prefill_tokens(cache, b, newly_assigned, prefill_start, bm=bm)
                if d_cache is not None:
                    # the draft's cache follows every prompt too, cut to ITS
                    # window (the proposal gate below keeps a slot off the
                    # draft once it nears that window)
                    d_lim = draft.max_seq_len - 1
                    _, d_cache = draft._prefill_tokens(
                        d_cache, b, {s: t[:d_lim] for s, t in newly_assigned.items()},
                        {s: 0 for s in newly_assigned})
            if bm is not None:
                if self.prefix_cache:
                    # index the freshly prefilled prompt pages for sharing
                    for s in newly_assigned:
                        bm.register_prefix(s, prompt_toks[s])
                for s in range(b):
                    if req_id[s] != -1:
                        bm.append_token(s, int(pos[s]))
            past_prompts = all(req_id[s] == -1 or pos[s] >= len(prompt_toks[s]) - 1
                               for s in range(b))

            # prompt-lookup speculation (engine.py:897-990 of the JAX
            # package): each active slot proposes up to spec_lookup tokens,
            # ONE bucketed full-logits prefill verifies the batch, and each
            # slot commits its accepted prefix plus a correction or bonus
            # token: greedy slots by argmax prefix match, stochastic ones by
            # point-mass rejection sampling against the warped target
            # distribution. Rows written for rejected positions sit at or
            # past the new decode point and are overwritten before any read.
            spec_props = None
            if self.spec_lookup > 0 and past_prompts:
                d_all = None
                d_ok = [False] * b
                if d_chain is not None:
                    # a slot within spec_lookup of the DRAFT's window proposes
                    # by lookup: the chain would run past that window. The
                    # chain runs such a slot from row 0 instead, so that every
                    # row it reads lies in the window; the slot's draft rows
                    # are not read again before its next request's prefill
                    d_s = d_cache.k.shape[3]
                    d_ok = [req_id[s] != -1 and int(pos[s]) + self.spec_lookup <= d_s
                            for s in range(b)]
                    if any(d_ok):
                        d_dev, d_cache = d_chain(draft.params, d_cache,
                                                 self._dev(np.where(d_ok, token, 0)),
                                                 self._dev(np.where(d_ok, pos, 0)))
                        d_all = d_dev.cpu().numpy()  # (B, spec_lookup)
                spec_props = {}
                # the verify needs kk + 1 rows in one prefill bucket
                kk_cap = max(self.prefill_buckets) - 1
                for s in range(b):
                    if req_id[s] == -1:
                        continue
                    kk = min(self.spec_lookup, kk_cap, self.max_seq_len - 1 - int(pos[s]))
                    if d_all is not None and d_ok[s]:
                        spec_props[s] = [int(t) for t in d_all[s, :kk]]
                    else:
                        spec_props[s] = _lookup_propose(hist[s], kk) if kk > 0 else []
                if not any(spec_props.values()):
                    spec_props = None  # nothing proposed: a plain step instead
            if spec_props is not None:
                tb = _bucket(max(len(p) for p in spec_props.values()) + 1, self.prefill_buckets)
                chunk_toks = np.zeros((b, tb), np.int32)
                valid = np.zeros((b,), np.int32)
                for s, pr in spec_props.items():
                    chunk_toks[s, 0] = token[s]
                    chunk_toks[s, 1:1 + len(pr)] = pr
                    valid[s] = 1 + len(pr)
                logits, cache = self._prefill(self.params, cache, self._dev(chunk_toks),
                                              self._dev(pos), self._dev(valid))
                logits_h = logits.cpu().numpy()
                for s, pr in spec_props.items():
                    sp = samplers[req_id[s]]
                    rows = logits_h[s, : valid[s]]
                    if sp.temperature == 0.0:
                        g = np.argmax(rows, axis=1)
                        n_acc = 0
                        while n_acc < len(pr) and pr[n_acc] == int(g[n_acc]):
                            n_acc += 1
                        commits = pr[:n_acc] + [int(g[n_acc])]
                    else:
                        ws = [_warp(r, sp.temperature, sp.topp) for r in rows]
                        commits, n_acc = _verify_round(ws, None, pr, sp.rng)
                    if d_all is not None and d_ok[s] and pr and n_acc == len(pr):
                        # full acceptance with a draft: drop the bonus token.
                        # The draft never wrote the row of its LAST proposal,
                        # so committing past it would leave a hole in the
                        # draft's cache; the next chain derives it again
                        commits = commits[:n_acc]
                    spec_proposed += len(pr)
                    spec_accepted += n_acc
                    if any(commit(s, nxt) for nxt in commits):
                        retire_slot(s)
                continue

            # multi-step scheduling (engine.py:1017-1060 of the JAX package):
            # when every active slot is past its prompt and has chunk_steps of
            # budget left, the whole chunk runs with the sampled tokens fed on
            # the device, and the scheduler walks the (B, N) tokens. A slot
            # that retires mid-chunk is released at once; its later tokens
            # are discarded with the cache rows they wrote.
            chunk_ok = (
                self._chunk is not None and past_prompts
                and max((int(pos[s]) for s in range(b) if req_id[s] != -1),
                        default=steps) + self.chunk_steps <= steps
            )
            if chunk_ok and bm is not None:
                # the page table is fixed for the whole chunk: reserve the
                # pages of positions [pos, pos + chunk_steps) of every active
                # slot, or take single steps until a retirement frees pages
                try:
                    for s in range(b):
                        if req_id[s] != -1:
                            bm.ensure_capacity(s, int(pos[s]) + self.chunk_steps)
                except OutOfPagesError:
                    chunk_ok = False
            if chunk_ok:
                args = (self._dev(token), self._dev(pos))
                if bm is not None:
                    args = (self._table(bm, b),) + args
                toks_dev, cache = self._chunk(self.params, cache, *args, self._ds_gen)
                toks_ch = toks_dev.cpu().numpy()  # (B, N)
                for t in range(self.chunk_steps):
                    advance_and_retire(None, toks_ch[:, t])
            elif self._sstep is not None:
                nxt_dev, cache = self._sstep(self.params, cache, self._dev(token),
                                             self._dev(pos), self._ds_gen)
                advance_and_retire(None, nxt_dev.cpu().numpy())
            else:
                logits_h, cache = self._do_step(cache, token, pos, bm)
                advance_and_retire(logits_h, None)

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
                prefix_hit_tokens=bm.prefix_hit_tokens if bm is not None else 0,
                spec_proposed=spec_proposed,
                spec_accepted=spec_accepted,
            )
        return gen_cnt
