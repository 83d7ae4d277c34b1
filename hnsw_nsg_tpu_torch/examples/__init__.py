"""Example scripts on the PyTorch port, one per example of the repo's
``examples/``: ``python -m hnsw_nsg_tpu_torch.examples.<name> [device]``
(default device: the card)."""
