"""Sort / scan / multisearch building blocks (counterparts of
``repro.primitives``)."""
