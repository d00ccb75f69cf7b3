"""Parallelism over `torch.distributed`: the spec trees and the explicit
plan (`sharding`), the collectives (`comm`) and the GPipe pipeline
(`pipeline`)."""
