"""Serving features on the tiering runtime: the tiered paged KV cache
(:mod:`tiered_kv`) and MoE expert-weight tiering (:mod:`expert_tiering`)."""
