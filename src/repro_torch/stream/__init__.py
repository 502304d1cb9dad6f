"""Streaming stack of the port: communication accounting and the fused
pseudo-score diagnostic (the streaming estimator is a later slice)."""
