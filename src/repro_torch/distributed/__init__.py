"""Fault injection, bounded retry and the restart driver, and the sharding
rules of tensor-parallel serving."""
