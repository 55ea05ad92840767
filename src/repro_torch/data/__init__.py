"""Edge streams and host-side prefetch (counterpart of ``repro.data``)."""
