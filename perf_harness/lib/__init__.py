"""The harness's parts: the manifest, the sweep driver, the profiler
window, the count of simulated work and the check against the plain
reference."""
