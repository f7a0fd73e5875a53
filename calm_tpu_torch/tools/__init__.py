"""Measurement tools of the port, run as ``python -m
calm_tpu_torch.tools.<name>``: ``dma_ceiling`` (the card's attainable HBM
read rate) and ``gf4_bound`` (the gf4 decode ceiling) on a CUDA GPU,
``perf`` (the roofline report and the per-op table of a decode or a
prefill; on the CPU under ``CALM_CPU=1``) and ``sol`` (the analytic
roofline, arithmetic only)."""
