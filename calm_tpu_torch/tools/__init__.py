"""Tools of the port, run as ``python -m calm_tpu_torch.tools.<name>``:
``dma_ceiling`` (the card's attainable HBM read rate) and ``gf4_bound``
(the gf4 decode ceiling) on a CUDA GPU; ``convert`` (HF checkpoint ->
.calm, on the host); ``accept`` (the BASELINE acceptance gate),
``quality`` (format SNR and logit drift), ``bench`` (``bench.py``'s
decode and prefill protocol), ``serve_bench`` (serving throughput and
TTFT) and ``perf`` (the roofline report and the per-op table), each on
the GPU or, under ``CALM_CPU=1``, the CPU; ``sol`` (the analytic
roofline, arithmetic only)."""
