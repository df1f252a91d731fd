"""Milliseconds a cycle spends outside the decide: publication, ingest, qrun."""
from twinbench.readers import ingest_ms as read  # noqa: F401
