"""Counterparts of the JAX package's tools: the fused Inception block A/B
and the dynamic-roll reproduction (the tool kernels), the flow-quality
gate, and the extraction measurement tools (flow_bench, warm_stages,
extract_stages, pipeline_overlap, tick_sweep, parity_embeddings,
scaling_curve, cnn_roofline). Imports nothing eagerly."""
