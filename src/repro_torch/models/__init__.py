"""The model substrate (``repro.models``): shared layers, the transformer
LM family, the GNN, equivariant and BERT4Rec families and the sparse
embedding ops, as plain functions over explicit param dicts of tensors."""
