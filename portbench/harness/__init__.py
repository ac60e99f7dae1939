"""The benchmark's general machinery: weights, system, traffic, loops, trace, work and the
comparison that decides ``correct``."""
