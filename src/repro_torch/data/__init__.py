"""Edge streams, host-side prefetch, LM token batches and k-hop graph
sampling (counterpart of ``repro.data``)."""
