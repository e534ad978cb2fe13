"""Deterministic synthetic LM data (:mod:`pipeline`)."""
