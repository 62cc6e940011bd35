"""Compute ops: weight-only quantized matmul and the fused LayerNorm / FlashAttention wrappers."""
