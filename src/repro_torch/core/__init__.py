"""Speculative decoding, verification and the gamma planners."""
