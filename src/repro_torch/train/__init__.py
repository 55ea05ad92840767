"""Checkpointing (counterpart of ``repro.train``, checkpoint part)."""
