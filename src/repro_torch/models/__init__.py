"""The model substrate (``repro.models``): shared layers and the transformer
LM family, as plain functions over explicit param dicts of tensors."""
