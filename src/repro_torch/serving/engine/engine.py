"""Continuous-batching serving engine over a tile-aligned KV slot pool.

One `Engine` owns: the bucket policy (shapes snapped to the hardware tile
lattice — `buckets`), a fixed `SlotPool` of KV cache slots, and three step
functions, run eagerly:

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

Failure semantics follow the JAX engine: `run()` never raises for a
per-request problem.  Invalid requests become `rejected` completions before
they touch a slot, admission control (`scheduler.ShedPolicy`) sheds under
overload, and per-request deadlines time out with partial results.  The
block-table pool (prefix caching, KV preemption), int8 KV, fault injection
and observability come with later slices; their switches raise here.

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
from .buckets import BucketPolicy, make_policy
from .kv_pool import SlotPool
from .request import Completion, EngineStats, Request
from .scheduler import RequestQueue, Scheduler, ShedPolicy


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


def _stream_seed(seed: int, step: int) -> int:
    """Seed of a request's sample at `step`: independent of slot placement
    and step timing, so sampling is reproducible across scheduling
    policies (within the port; not held to JAX's `fold_in` streams)."""
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


@dataclasses.dataclass
class _SlotState:
    req: Request
    generated: List[int]
    last_t_s: float            # engine-clock time of the latest token
    first_token_s: float
    itl_s: List[float]


class Engine:
    """Continuous-batching engine; see module docstring."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_batch: int = 8, max_prompt: int = 64,
                 max_new: int = 64, hw: Optional[Hardware] = None,
                 policy: Optional[BucketPolicy] = None,
                 use_paged_kernel: bool = False,
                 grow_batch: bool = False,
                 prefix_cache: bool = False,
                 kv_dtype: str = "auto",
                 device=None):
        _check_supported(cfg)
        if prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True (block-table pool) is not ported yet: it comes "
                "with the prefix-cache slice")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r}; valid: {list(KV_DTYPES)}")
        if kv_dtype != "auto":
            raise NotImplementedError(
                "kv_dtype='int8' is not ported yet: it comes with the low-precision slice")
        self.device = resolve_device(device)
        embed_dev = params["embed"].device
        if embed_dev.type != self.device.type:
            raise ValueError(f"params live on {embed_dev}, the engine runs on {self.device}")
        if use_paged_kernel:
            cfg = dataclasses.replace(cfg, attn_impl="paged")
        self.params = params
        self.cfg = cfg
        self.policy = policy or make_policy(
            cfg, hw or get_hardware(), max_batch=max_batch, max_prompt=max_prompt,
            max_seq=max_prompt + max_new, grow_batch=grow_batch)
        self.pool = SlotPool(cfg, self.policy.num_slots, self.policy.seq_max,
                             compute_dtype(cfg.dtype), self.device)
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
        self.step_s_estimate = 0.0      # set by calibrate_step_s

    def reset_stats(self) -> None:
        """Zero the step counters (run() does this itself on entry)."""
        self.decode_steps = 0
        self.prefills = 0

    def calibrate_step_s(self) -> float:
        """Warm every bucket's prefill + the pool decode step, then time one
        decode step (used to express arrival patterns in machine-relative
        units, and as the TTFT predictor of `ShedPolicy`).  The first run
        pays the one-time costs (the kernel build); the second is the timer."""
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
        return None

    def _reject(self, req: Request, detail: str, done: List[Completion]) -> None:
        self._drop(req, "rejected", detail, done)

    def _drop(self, req: Request, reason: str, detail: str,
              done: List[Completion]) -> None:
        """Finalize a request dropped before admission (rejected / shed /
        timed out while queued)."""
        done.append(Completion(
            rid=req.rid, prompt_len=req.prompt_len, tokens=[],
            arrival_s=req.arrival_s, first_token_s=None, done_s=self._now(),
            finish_reason=reason, detail=detail))

    def _admit(self, req: Request, slot: int, states: Dict[int, _SlotState],
               done: List[Completion]) -> None:
        bucket = self.policy.prompt_bucket(req.prompt_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :req.prompt_len] = req.tokens
        logits, caches = self._prefill(
            self.params, torch.as_tensor(padded, device=self.device), req.prompt_len)
        self.pool.write(slot, caches, req.prompt_len)
        sp = req.sampling
        seed = sp.seed or req.rid
        tok0 = int(sample(logits, np.asarray([sp.temperature], np.float32),
                          np.asarray([seed]), np.asarray([0]))[0])
        self.prefills += 1
        t = self._now()
        self._last_tok[slot] = tok0
        self._temps[slot] = sp.temperature
        self._seeds[slot] = seed
        self._steps[slot] = 1
        st = _SlotState(req=req, generated=[tok0], last_t_s=t, first_token_s=t, itl_s=[])
        if self._finished(st):
            self._complete(slot, st, states, done)
        elif (req.deadline_s is not None and t > req.arrival_s + req.deadline_s):
            self._complete(slot, st, states, done, reason="timeout",
                           detail=f"deadline {req.deadline_s:.3f}s expired after first token")
        else:
            states[slot] = st

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
            done_s=self._now(), itl_s=st.itl_s, finish_reason=reason, detail=detail))
        states.pop(slot, None)
        self._temps[slot] = 0.0
        self.pool.release(slot)

    # -- main loop -----------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @torch.no_grad()
    def run(self, requests: List[Request], *, policy: str = "continuous",
            shed: Optional[ShedPolicy] = None) -> Tuple[List[Completion], EngineStats]:
        """Serve `requests`; returns (completions sorted by request id,
        aggregate stats).  Every request gets exactly one Completion.
        policy="static" = drain-then-refill baseline; `shed` = admission
        control (scheduler.ShedPolicy)."""
        self.reset_stats()
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
                        self._reject(req, "unadmittable with an idle pool "
                                          "(exceeds usable capacity)", done)
                continue
            self._step(states, done)

        wall = self._now()
        done.sort(key=lambda c: c.rid)
        return done, EngineStats.collect(done, wall, decode_steps=self.decode_steps,
                                         prefills=self.prefills)

    def _step(self, states: Dict[int, _SlotState], done: List[Completion]) -> None:
        """One pool-wide decode step: every live slot advances one token."""
        dev = self.device
        pos = torch.as_tensor(np.asarray(self.pool.lengths, np.int32), device=dev)
        tok = torch.as_tensor(self._last_tok[:, None], device=dev)
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
