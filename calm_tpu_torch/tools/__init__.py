"""Measurement tools of the port, run as ``python -m
calm_tpu_torch.tools.<name>`` on a CUDA GPU: ``dma_ceiling`` (the card's
attainable HBM read rate) and ``gf4_bound`` (the gf4 decode ceiling)."""
