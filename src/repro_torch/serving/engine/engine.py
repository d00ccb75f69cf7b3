"""Continuous-batching serving engine over a tile-aligned KV pool.

One `Engine` owns: the bucket policy (shapes snapped to the hardware tile
lattice — `buckets`), a fixed `SlotPool` of KV cache slots (or a block-table
`PagedPool`), and three step functions, run eagerly:

  * prefill — a single request, right-padded to its prompt bucket, cache
    written at positions 0..bucket (the pad tail is masked by the slot
    length everywhere downstream), then copied into the request's slot;
  * decode — ONE step for the whole pool: every slot advances one token with
    per-slot write positions (vector cache_index) and per-slot causal masks;
    dead slots ride along masked;
  * sample — greedy argmax, or temperature sampling from a per-request
    `torch.Generator` seeded from (seed, step).

The host loop interleaves admission (prefill into freed slots) with pool
decode steps — continuous batching.  `policy="static"` runs the same
machinery but only refills the pool once it has fully drained.

`prefix_cache=True` swaps the slot pool for the block-table pool
(`kv_pool.PagedPool`): every admission binds a block table that shares the
prompt's cached full blocks and prefills only the uncached suffix, at
cache_index = start, into the row's gathered contiguous view, which is then
scattered back; decode writes each row's token through its table and reads
K/V through the block-table kernel (`attn_impl="paged"`) or a gather.
`kv_dtype="int8"` stores either pool as int8 with f32 scales per (token,
kv head).  `cfg.linear_impl="quantized"` serves int8 weights through the
int8 GEMM and fused-MLP kernels, from float params (each weight quantized
per call, as the JAX engine does under jit) or from
`models.linear.quantize_linear_params` output (quantized once); the
engine reads only the bf16 embedding's device and casts no param.

Failure semantics follow the JAX engine: `run()` never raises for a
per-request problem.  Invalid requests become `rejected` completions before
they touch a slot, admission control (`scheduler.ShedPolicy`) sheds under
overload, and per-request deadlines time out with partial results.  KV
backpressure mid-decode (block-pool exhaustion while making write positions
appendable) preempts the youngest sequence with exact rollback: its full
KV blocks are committed to the prefix cache, the request re-queues, and on
re-admission only the uncached tail is re-prefilled, so outputs stay
token-identical.  Retries are bounded; a request that exhausts them
completes as `preempted-retry-exhausted` with the tokens it has.  Fault
injection, observability and the tuning-cache lookups come with later
slices; their switches raise here.

Device: the engine runs where its params live — CUDA by default (it raises
when there is no card), or the CPU when the caller passes device="cpu",
where every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...configs.base import ModelConfig
from ...core.hardware import Hardware, get_hardware
from ...models import apply_lm, init_caches
from ...models.blocks import KV_DTYPES
from ...models.layers import compute_dtype
from ...tuning.candidates import bucket_steps, sublane_granule
from .buckets import BucketPolicy, make_policy
from .kv_pool import PagedPool, PoolExhausted, SlotPool
from .request import Completion, EngineStats, Request
from .scheduler import RequestQueue, Scheduler, ShedPolicy

# Preemptions and failed re-admissions a request may take before it
# completes as `preempted-retry-exhausted` (or is shed).  The JAX engine's
# `preempt_retries` argument, fixed at its default until a caller needs
# another value.
PREEMPT_RETRIES = 4

def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"engine v1 serves attention-based decoders (dense/moe); "
            f"got family={cfg.family!r}")
    if cfg.attn_type != "gqa":
        raise NotImplementedError("engine v1 requires attn_type='gqa' "
                                  "(MLA latent caches: future work)")
    if cfg.pos_emb != "rotary":
        raise NotImplementedError("engine v1 requires rotary positions")
    if cfg.is_encoder_decoder or cfg.num_patches:
        raise NotImplementedError("engine v1 serves text-only decoders")


def resolve_device(device) -> torch.device:
    """`device`, or CUDA when None — raising when there is no card (the
    port never carries on on the CPU unless asked to)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


def _make_prefill(cfg: ModelConfig, s_max: int):
    """(params, tokens (1, bucket), true_len) -> (logits (1, v), caches).

    Logits are taken at the last *real* prompt position; cache entries past
    true_len hold pad garbage that per-slot lengths mask downstream.
    """

    def prefill(params, tokens, true_len: int):
        caches = init_caches(cfg, 1, s_max, compute_dtype(cfg.dtype), tokens.device)
        logits, caches = apply_lm(params, tokens, cfg, caches=caches, cache_index=0)
        return logits[:, true_len - 1], caches

    return prefill


def _make_decode(cfg: ModelConfig):
    """(params, tok (slots, 1), caches, pos (slots,)) -> (logits, caches).

    pos is the per-slot write position (== live kv length); the pool's
    caches are written in place.
    """

    def decode(params, tok, caches, pos):
        logits, caches = apply_lm(params, tok, cfg, caches=caches, cache_index=pos)
        return logits[:, -1], caches

    return decode


def _make_prefix_prefill(cfg: ModelConfig):
    """Cache-backed suffix prefill for the block-table engine.

    (params, tokens (1, bucket), true_len, start, contig) -> (logits, contig)

    `contig` is the row's gathered contiguous (1, seq_max) cache view:
    positions [0, start) hold live prefix-cache KV, and the suffix tokens are
    prefilled at cache_index = start (positions start..start+bucket).  A cold
    prompt is just start = 0 over a garbage view.  The view is written in
    place, then scattered back to the row's blocks.
    """

    def prefill(params, tokens, true_len: int, start: int, caches):
        logits, caches = apply_lm(params, tokens, cfg, caches=caches, cache_index=start)
        return logits[:, true_len - 1], caches

    return prefill


def _make_decode_bt(cfg: ModelConfig):
    """Block-table decode: like `_make_decode`, but the caches are a physical
    block pool and each row's KV is addressed through (tables, pos)."""

    def decode(params, tok, caches, pos, tables):
        logits, caches = apply_lm(params, tok, cfg, caches=caches, cache_index=pos,
                                  block_tables=tables)
        return logits[:, -1], caches

    return decode


def _stream_seed(seed: int, step: int) -> int:
    """Seed of a request's sample at `step`: independent of slot placement
    and step timing, so sampling is reproducible across scheduling
    policies and across preemption and resume (within the port; not held
    to JAX's `fold_in` streams)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


def sample(logits: torch.Tensor, temps: np.ndarray, seeds: np.ndarray,
           steps: np.ndarray) -> np.ndarray:
    """(logits (n, v), temps, seeds, steps) -> tokens (n,) int32.

    temperature 0 -> argmax (first maximum, as jnp.argmax); else one
    categorical draw from logits / t with a generator seeded from
    (seed, step)."""
    out = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    for i in np.flatnonzero(temps > 0):
        gen = torch.Generator(device=logits.device).manual_seed(
            _stream_seed(seeds[i], steps[i]))
        p = torch.softmax(logits[i].float() / max(float(temps[i]), 1e-6), dim=-1)
        out[i] = int(torch.multinomial(p, 1, generator=gen).item())
    return out


class _DeadEnd(Exception):
    """A resumed request whose warm blocks were evicted presents a suffix
    wider than the prompt-bucket lattice: it can never be re-admitted."""


@dataclasses.dataclass
class _SlotState:
    req: Request
    generated: List[int]
    last_t_s: float            # engine-clock time of the latest token
    first_token_s: float
    itl_s: List[float]
    cached_tokens: int = 0     # prompt KV served from the prefix cache
    preemptions: int = 0       # times this request has been preempted
    admit_seq: int = 0         # monotonic admission index (youngest = max)


@dataclasses.dataclass
class _ResumeState:
    """Rolled-back progress of a preempted request awaiting re-admission.

    `generated` are the tokens already produced; all KV up to the last full
    block was committed to the prefix cache at preemption, so re-admission
    re-prefills at most one block of tail."""
    generated: List[int]
    first_token_s: float
    last_t_s: float
    itl_s: List[float]
    cached_tokens: int
    attempts: int              # preemptions + failed re-admissions so far


class Engine:
    """Continuous-batching engine; see module docstring."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_batch: int = 8, max_prompt: int = 64,
                 max_new: int = 64, hw: Optional[Hardware] = None,
                 policy: Optional[BucketPolicy] = None,
                 use_paged_kernel: bool = False,
                 grow_batch: bool = False,
                 prefix_cache: bool = False,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_dtype: str = "auto",
                 device=None):
        _check_supported(cfg)
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r}; valid: {list(KV_DTYPES)}")
        self.device = resolve_device(device)
        embed_dev = params["embed"].device
        if embed_dev.type != self.device.type:
            raise ValueError(f"params live on {embed_dev}, the engine runs on {self.device}")
        if use_paged_kernel:
            cfg = dataclasses.replace(cfg, attn_impl="paged")
        if kv_dtype != "auto":
            # int8 pool: k/v leaves store 1 byte per element beside f32
            # per-(token, head) scale leaves; the pools, the step functions
            # and the paged kernels all key off cfg.kv_dtype
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        self.params = params
        self.cfg = cfg
        hw = hw or get_hardware()
        self.policy = policy or make_policy(
            cfg, hw, max_batch=max_batch, max_prompt=max_prompt,
            max_seq=max_prompt + max_new, grow_batch=grow_batch)
        self.prefix_cache = prefix_cache
        dt = compute_dtype(cfg.dtype)
        if prefix_cache:
            self.pool = PagedPool(cfg, self.policy.num_slots, self.policy.seq_max, dt,
                                  self.device, block_size=block_size or self._pick_block_size(hw),
                                  num_blocks=num_blocks)
            # every admission is a cache-backed *suffix* prefill (a cold
            # prompt is a suffix at start=0), bucketed on the suffix length
            self._prefill = _make_prefix_prefill(cfg)
            self._decode = _make_decode_bt(cfg)
        else:
            assert num_blocks is None, \
                "num_blocks applies to the prefix_cache (block-table) pool"
            self.pool = SlotPool(cfg, self.policy.num_slots, self.policy.seq_max, dt,
                                 self.device)
            self._prefill = _make_prefill(cfg, self.policy.seq_max)
            self._decode = _make_decode(cfg)
        # per-slot state fed to the decode step (dead slots: token 0, temp 0)
        n = self.policy.num_slots
        self._last_tok = np.zeros(n, np.int32)
        self._temps = np.zeros(n, np.float32)
        self._seeds = np.zeros(n, np.int64)
        self._steps = np.zeros(n, np.int64)
        self.decode_steps = 0
        self.prefills = 0
        self.preemptions = 0
        self.resumes = 0
        self.step_s_estimate = 0.0      # set by calibrate_step_s
        self._resume: Dict[int, _ResumeState] = {}
        self._admit_attempts: Dict[int, int] = {}
        self._admit_counter = 0
        self._queue: Optional[RequestQueue] = None

    def _pick_block_size(self, hw: Hardware) -> int:
        """Physical KV block size: the smallest divisor of seq_max on the
        bucket lattice that is >= 16 — fine-grained enough to share
        prefixes, still a whole number of register tiles.  The JAX engine
        first asks its tuning cache (`paged_decode_blocktable_pool`); the
        port has none yet (it comes with the tuning slice), so it takes this
        fallback, which is 64 on the H100 (sublane granule 64)."""
        s_max = self.policy.seq_max
        sub = sublane_granule(hw, torch.finfo(compute_dtype(self.cfg.dtype)).bits // 8)
        divisors = [b for b in bucket_steps(s_max, sub) if s_max % b == 0]
        for b in divisors:
            if b >= 16:
                return b
        return divisors[-1] if divisors else s_max

    def reset_stats(self) -> None:
        """Zero the step counters (run() does this itself on entry)."""
        self.decode_steps = 0
        self.prefills = 0
        self.preemptions = 0
        self.resumes = 0

    def calibrate_step_s(self) -> float:
        """Warm every bucket's prefill + the pool decode step, then time one
        decode step (used to express arrival patterns in machine-relative
        units, and as the TTFT predictor of `ShedPolicy`).  The first run
        pays the one-time costs (the kernel build); the second is the timer.
        A distinct token fill per bucket keeps the prefix cache from
        deduplicating the warm prompts."""
        warm = [Request(rid=i, tokens=np.full(b, 1 + i, np.int32),
                        max_new_tokens=min(4, max(self.policy.seq_max - b, 1)))
                for i, b in enumerate(self.policy.prompt_buckets)]
        self.run(warm)
        _, stats = self.run(warm)
        self.step_s_estimate = stats.wall_s / max(stats.decode_steps, 1)
        return self.step_s_estimate

    # -- admission -----------------------------------------------------------

    def _admission_error(self, req: Request) -> Optional[str]:
        """Why `req` can never be served (None when it can).  Checked before
        a request enters the queue, so a bad request never touches a slot."""
        if req.prompt_len < 1:
            return "empty prompt"
        if req.max_new_tokens < 1:
            return f"max_new_tokens {req.max_new_tokens} < 1"
        toks = np.asarray(req.tokens)
        if not np.issubdtype(toks.dtype, np.integer):
            return f"prompt tokens must be integers, got {toks.dtype}"
        lo, hi = int(toks.min()), int(toks.max())
        if lo < 0 or hi >= self.cfg.padded_vocab_size:
            return (f"prompt token ids [{lo}, {hi}] outside "
                    f"[0, {self.cfg.padded_vocab_size})")
        try:
            self.policy.prompt_bucket(req.prompt_len)
        except ValueError as e:
            return str(e)
        if req.prompt_len + req.max_new_tokens > self.policy.seq_max:
            return (f"prompt {req.prompt_len} + gen {req.max_new_tokens} "
                    f"exceeds pool depth {self.policy.seq_max}")
        if self.prefix_cache:
            need = -(-req.prompt_len // self.pool.block_size)
            if need > self.pool.blocks.num_blocks:
                return (f"prompt needs {need} KV blocks; the pool only has "
                        f"{self.pool.blocks.num_blocks}")
        return None

    def _reject(self, req: Request, detail: str, done: List[Completion]) -> None:
        done.append(Completion(
            rid=req.rid, prompt_len=req.prompt_len, tokens=[],
            arrival_s=req.arrival_s, first_token_s=None, done_s=self._now(),
            finish_reason="rejected", detail=detail))

    def _drop(self, req: Request, reason: str, detail: str,
              done: List[Completion]) -> None:
        """Finalize a request dropped before (re-)admission: shed / timeout
        from the scheduler, or a dead-end re-admission.  A preempted request
        keeps its partial tokens; its reason stays `timeout` when the
        deadline fired, else becomes `preempted-retry-exhausted` (it *was*
        being served — "shed" would misreport it as never admitted)."""
        res = self._resume.pop(req.rid, None)
        if res is None:
            done.append(Completion(
                rid=req.rid, prompt_len=req.prompt_len, tokens=[],
                arrival_s=req.arrival_s, first_token_s=None, done_s=self._now(),
                finish_reason=reason, detail=detail))
        else:
            reason = reason if reason == "timeout" else "preempted-retry-exhausted"
            done.append(Completion(
                rid=req.rid, prompt_len=req.prompt_len, tokens=res.generated,
                arrival_s=req.arrival_s, first_token_s=res.first_token_s,
                done_s=self._now(), itl_s=res.itl_s, cached_tokens=res.cached_tokens,
                finish_reason=reason, detail=detail, preemptions=res.attempts))

    def _admit(self, req: Request, slot: int, states: Dict[int, _SlotState],
               done: List[Completion]) -> None:
        res = self._resume.pop(req.rid, None)
        try:
            if self.prefix_cache:
                logits, cached = self._prefill_paged(req, slot, res)
            else:
                cached = 0
                bucket = self.policy.prompt_bucket(req.prompt_len)
                padded = np.zeros((1, bucket), np.int32)
                padded[0, :req.prompt_len] = req.tokens
                logits, caches = self._prefill(
                    self.params, torch.as_tensor(padded, device=self.device), req.prompt_len)
                self.pool.write(slot, caches, req.prompt_len)
        except PoolExhausted as e:
            # admission raced a COW burst: the slot is returned, the request
            # re-queued with a bounded retry budget
            self.pool.release(slot)
            self._retry_admission(req, res, f"pool exhausted: {e}", done)
            return
        except _DeadEnd as e:
            self.pool.release(slot)
            self._drop_or_requeue_dead_end(req, res, str(e), done)
            return
        sp = req.sampling
        seed = sp.seed or req.rid
        m = len(res.generated) if res is not None else 0
        tok0 = int(sample(logits, np.asarray([sp.temperature], np.float32),
                          np.asarray([seed]), np.asarray([m]))[0])
        self.prefills += 1
        self._admit_counter += 1
        self._admit_attempts.pop(req.rid, None)
        t = self._now()
        self._last_tok[slot] = tok0
        self._temps[slot] = sp.temperature
        self._seeds[slot] = seed
        self._steps[slot] = m + 1
        if res is None:
            st = _SlotState(req=req, generated=[tok0], last_t_s=t, first_token_s=t,
                            itl_s=[], cached_tokens=cached, admit_seq=self._admit_counter)
        else:
            # resume: sampling re-enters the request's stream at step m, so
            # the continuation is what the uninterrupted run would have
            # produced; the preemption stall lands in the ITL trace
            self.resumes += 1
            st = _SlotState(req=req, generated=res.generated + [tok0], last_t_s=t,
                            first_token_s=res.first_token_s,
                            itl_s=res.itl_s + [t - res.last_t_s],
                            cached_tokens=res.cached_tokens, preemptions=res.attempts,
                            admit_seq=self._admit_counter)
        if self._finished(st):
            self._complete(slot, st, states, done)
        elif (req.deadline_s is not None and t > req.arrival_s + req.deadline_s):
            self._complete(slot, st, states, done, reason="timeout",
                           detail=f"deadline {req.deadline_s:.3f}s expired after first token")
        else:
            states[slot] = st

    def _retry_admission(self, req: Request, res: Optional[_ResumeState],
                         detail: str, done: List[Completion]) -> None:
        attempts = (res.attempts if res is not None
                    else self._admit_attempts.get(req.rid, 0)) + 1
        if attempts > PREEMPT_RETRIES:
            if res is not None:
                self._resume[req.rid] = res   # _drop consumes it
                self._drop(req, "preempted-retry-exhausted",
                           f"{detail} ({attempts} attempts)", done)
            else:
                self._drop(req, "shed", f"{detail} ({attempts} admission attempts)", done)
            return
        if res is not None:
            res.attempts = attempts
            self._resume[req.rid] = res
        else:
            self._admit_attempts[req.rid] = attempts
        self._queue.push(req)

    def _drop_or_requeue_dead_end(self, req: Request, res: Optional[_ResumeState],
                                  detail: str, done: List[Completion]) -> None:
        if res is not None:
            self._resume[req.rid] = res
            self._drop(req, "preempted-retry-exhausted", detail, done)
        else:
            self._reject(req, detail, done)

    def _prefill_paged(self, req: Request, slot: int,
                       res: Optional[_ResumeState]) -> Tuple[torch.Tensor, int]:
        """Paged admission: bind a block table (sharing every cached full
        prefix block), prefill only the uncached suffix, scatter the new
        blocks back, and register the prompt's full blocks for future hits.
        A resumed request prefills prompt + generated-so-far; its full
        blocks were committed at preemption, so the suffix is at most one
        block plus the un-advanced last token.
        Returns (last-token logits (1, v), cached token count).

        The suffix is written at start = num_cached, padded to its bucket but
        never past seq_max: a resumed request can reach start + bucket >
        seq_max, and the pad that would not fit is cut here.  (The JAX
        engine's `dynamic_update_slice` clamps the start there instead, over
        live prefix KV:
        tests/test_torch_prefix.py::test_suffix_prefill_past_the_pool_depth.)"""
        pool: PagedPool = self.pool
        tokens = np.asarray(req.tokens, np.int32)
        if res is not None:
            tokens = np.concatenate([tokens, np.asarray(res.generated, np.int32)])
        seq = pool.alloc_sequence(slot, tokens)
        p = seq.num_cached
        suffix = tokens[p:]
        try:
            bucket = self.policy.prompt_bucket(len(suffix))
        except ValueError as e:
            raise _DeadEnd(str(e)) from e
        padded = np.zeros((1, min(bucket, self.policy.seq_max - p)), np.int32)
        padded[0, :len(suffix)] = suffix
        contig = pool.gather(slot)
        logits, contig = self._prefill(
            self.params, torch.as_tensor(padded, device=self.device), len(suffix), p, contig)
        pool.scatter(slot, contig, p // pool.block_size)
        pool.commit(slot, tokens)
        return logits, (p if res is None else res.cached_tokens)

    def _finished(self, st: _SlotState) -> bool:
        if len(st.generated) >= st.req.max_new_tokens:
            return True
        eos = st.req.eos_id
        return eos is not None and st.generated[-1] == eos

    def _complete(self, slot: int, st: _SlotState, states: Dict[int, _SlotState],
                  done: List[Completion], *, reason: Optional[str] = None,
                  detail: str = "") -> None:
        if reason is None:
            eos = st.req.eos_id
            reason = ("stop" if eos is not None and st.generated
                      and st.generated[-1] == eos else "length")
        done.append(Completion(
            rid=st.req.rid, prompt_len=st.req.prompt_len, tokens=st.generated,
            arrival_s=st.req.arrival_s, first_token_s=st.first_token_s,
            done_s=self._now(), itl_s=st.itl_s, cached_tokens=st.cached_tokens,
            finish_reason=reason, detail=detail, preemptions=st.preemptions))
        states.pop(slot, None)
        self._temps[slot] = 0.0
        self.pool.release(slot)

    # -- preemption ----------------------------------------------------------

    def _pick_victim(self, states: Dict[int, _SlotState]) -> int:
        """Youngest live sequence (most recent admission): it has the least
        progress to roll back and the fewest tokens to re-prefill."""
        return max(states, key=lambda s: states[s].admit_seq)

    def _preempt(self, slot: int, states: Dict[int, _SlotState],
                 done: List[Completion]) -> None:
        """Exact rollback of `slot` under KV backpressure: commit every full
        block of its written KV to the prefix cache (so re-admission only
        re-prefills the tail), release the row, and re-queue the request at
        its original arrival position.  Out of retry budget -> complete as
        preempted-retry-exhausted with the tokens generated so far."""
        st = states.pop(slot)
        self.preemptions += 1
        self._temps[slot] = 0.0
        attempts = st.preemptions + 1
        if attempts > PREEMPT_RETRIES:
            self.pool.release(slot)
            done.append(Completion(
                rid=st.req.rid, prompt_len=st.req.prompt_len, tokens=st.generated,
                arrival_s=st.req.arrival_s, first_token_s=st.first_token_s,
                done_s=self._now(), itl_s=st.itl_s, cached_tokens=st.cached_tokens,
                finish_reason="preempted-retry-exhausted",
                detail=f"preempted {attempts}x; retry budget {PREEMPT_RETRIES}",
                preemptions=attempts))
            return
        # KV in the pool covers prompt + generated[:-1] (the newest token
        # has not been fed to decode yet); registering those full blocks is
        # what makes the rollback exact-and-cheap instead of a full refill
        written = np.concatenate([np.asarray(st.req.tokens, np.int32),
                                  np.asarray(st.generated[:-1], np.int32)])
        self.pool.commit(slot, written)
        self.pool.release(slot)
        self._resume[st.req.rid] = _ResumeState(
            generated=st.generated, first_token_s=st.first_token_s, last_t_s=st.last_t_s,
            itl_s=st.itl_s, cached_tokens=st.cached_tokens, attempts=attempts)
        self._queue.push(st.req)

    # -- main loop -----------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @torch.no_grad()
    def run(self, requests: List[Request], *, policy: str = "continuous",
            shed: Optional[ShedPolicy] = None, faults=None,
            check_invariants: bool = False) -> Tuple[List[Completion], EngineStats]:
        """Serve `requests`; returns (completions sorted by request id,
        aggregate stats).  Every request gets exactly one Completion.
        policy="static" = drain-then-refill baseline; `shed` = admission
        control (scheduler.ShedPolicy); check_invariants asserts the
        block-pool invariants after every decode step.  `faults` (a seeded
        FaultPlan) comes with the observability-and-faults slice."""
        if faults is not None:
            raise NotImplementedError(
                "run(faults=...) is not ported yet: fault injection comes with the "
                "observability-and-faults slice")
        self.reset_stats()
        self._resume = {}
        self._admit_attempts = {}
        self._admit_counter = 0
        self._t0 = time.perf_counter()
        done: List[Completion] = []
        valid: List[Request] = []
        for req in requests:
            err = self._admission_error(req)
            if err is None:
                valid.append(req)
            else:
                self._reject(req, err, done)
        queue = RequestQueue(valid)
        self._queue = queue
        sched = Scheduler(queue, self.pool, policy, shed=shed)
        states: Dict[int, _SlotState] = {}

        while not sched.drained:
            admits, sheds = sched.admissions(self._now())
            for s in sheds:
                self._drop(s.req, s.reason, s.detail, done)
            for req, slot in admits:
                self._admit(req, slot, states, done)
            if not states:
                if admits or sheds:
                    continue    # progress was made; re-evaluate immediately
                nxt = queue.next_arrival_s()
                now = self._now()
                if nxt is not None and nxt > now:
                    time.sleep(nxt - now + 1e-4)
                elif len(queue):
                    # ready requests, an idle pool, and still no admission:
                    # nothing left could free capacity — fail the head
                    # request rather than spin forever
                    req = queue.pop_ready(now)
                    if req is not None:
                        self._drop_or_requeue_dead_end(
                            req, self._resume.pop(req.rid, None),
                            "unadmittable with an idle pool (exceeds usable capacity)", done)
                continue
            self._step(states, done)
            if check_invariants and self.prefix_cache:
                self.pool.blocks.check()

        if check_invariants and self.prefix_cache:
            self.pool.blocks.check()
        self._queue = None
        wall = self._now()
        done.sort(key=lambda c: c.rid)
        return done, EngineStats.collect(done, wall, decode_steps=self.decode_steps,
                                         prefills=self.prefills,
                                         preemptions=self.preemptions, resumes=self.resumes)

    def _step(self, states: Dict[int, _SlotState], done: List[Completion]) -> None:
        """One pool-wide decode step: every live slot advances one token.
        On the block-table pool, KV backpressure (block exhaustion while
        making write positions appendable) preempts youngest-first instead
        of raising; preempted rows ride through the step masked-dead."""
        dev = self.device
        if self.prefix_cache:
            # make each live row's write position physically writable
            # (tail-block alloc / copy-on-write) before the device step
            for slot in list(states):
                while slot in states:   # a row preempted as a victim drops out
                    try:
                        self.pool.prepare_append(slot)
                        break
                    except PoolExhausted:
                        self._preempt(self._pick_victim(states), states, done)
            if not states:
                return      # every row was preempted: nothing to decode
        pos = torch.as_tensor(np.asarray(self.pool.lengths, np.int32), device=dev)
        tok = torch.as_tensor(self._last_tok[:, None], device=dev)
        if self.prefix_cache:
            tables = torch.as_tensor(self.pool.tables(), device=dev)
            logits, self.pool.caches = self._decode(self.params, tok, self.pool.caches, pos,
                                                    tables)
        else:
            logits, self.pool.caches = self._decode(self.params, tok, self.pool.caches, pos)
        toks = sample(logits, self._temps, self._seeds, self._steps)
        self.decode_steps += 1
        t = self._now()
        for slot in list(states):
            st = states[slot]
            tok = int(toks[slot])
            self.pool.advance(slot)
            self._last_tok[slot] = tok
            self._steps[slot] += 1
            st.generated.append(tok)
            st.itl_s.append(t - st.last_t_s)
            st.last_t_s = t
            if self._finished(st):
                self._complete(slot, st, states, done)
            elif (st.req.deadline_s is not None
                  and t > st.req.arrival_s + st.req.deadline_s):
                self._complete(
                    slot, st, states, done, reason="timeout",
                    detail=f"deadline {st.req.deadline_s:.3f}s expired "
                           f"after {len(st.generated)} tokens")
