"""Fault injection and bounded retry for the serving engine."""
