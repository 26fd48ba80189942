"""The harness's shared code: discovery, traffic, the wall-clock loop,
the device trace, flop and byte counts, the plain reference and the
comparison that decides ``correct``."""
