"""Continuous-batching serving engine over a tile-aligned KV pool.

Public surface:
  Engine                  — the serving loop (engine.py)
  Request / SamplingParams / Completion / EngineStats — request API
  FINISH_REASONS / OK_REASONS — the finish_reason catalog (request.py)
  BucketPolicy / make_policy — tile-aligned shape policy (buckets.py)
  SlotPool                — fixed KV slot pool (kv_pool.py)
  BlockPool / PagedPool / PoolExhausted — block-table KV pool with prefix
                            caching, copy-on-write and LRU eviction (kv_pool.py)
  ShedPolicy / Shed       — admission control / overload shedding
  synthetic_requests      — workload generator
"""
from .buckets import BucketPolicy, make_policy
from .engine import Engine
from .kv_pool import BlockPool, PagedPool, PoolExhausted, SlotPool
from .request import (FINISH_REASONS, OK_REASONS, Completion, EngineStats,
                      Request, SamplingParams)
from .scheduler import RequestQueue, Scheduler, Shed, ShedPolicy
from .workload import PATTERNS, synthetic_requests

__all__ = [
    "Engine", "Request", "SamplingParams", "Completion", "EngineStats",
    "FINISH_REASONS", "OK_REASONS", "BucketPolicy", "make_policy", "SlotPool",
    "BlockPool", "PagedPool", "PoolExhausted",
    "RequestQueue", "Scheduler", "Shed", "ShedPolicy", "PATTERNS",
    "synthetic_requests",
]
