"""Simulator core: address math, cache, queues, prefetcher, controller, famsim."""
