"""Fault injection and bounded retry for the serving engine, and the
sharding rules of tensor-parallel serving."""
