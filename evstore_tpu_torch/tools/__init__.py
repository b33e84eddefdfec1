"""Offline tools: alt-key generation, precision reduction, model export,
latency-CDF plots and embedding analysis.  Port of `evstore_tpu/tools/`."""
