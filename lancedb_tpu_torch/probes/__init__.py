"""Timing and design probes of the port on one CUDA card: the
counterparts of the reference's probe scripts, one module each, named
after its script.

- ``probe_adc_grouped`` (``scripts/probe_adc_grouped.py``): the grouped
  ADC scan (B3) against the per-pair scan (B1) and the one-hot einsum;
- ``probe_pq_real`` (``scripts/probe_pq_real.py``): the grouped route on
  a real 1M x 128 IVF_PQ build against the per-pair route;
- ``ab_adc8`` (``scripts/ab_adc8.py``): the ADC LUT sum, compare-select
  sweep against table gather (S1);
- ``ab_gather_min`` (``scripts/ab_gather_min.py``): the shared-memory
  table gather at the script's shapes (S2).

Each exposes ``run()``, which returns its records and raises without a
card, and runs alone as ``python -m lancedb_tpu_torch.probes.<name>``.
"""
